"""One run of one cell: the cell's parts found by name, set-up, the window,
the check, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<config>.json``)
and a traffic mix (``traffic/<traffic>.json``); its limits are in
``limits/<cell>.json`` and each metric it reports is read by
``metrics/<metric>.py`` (a module with ``read(rec)``, returning a number or
None; see ``load_metric``).  The configuration's ``reference`` (``"piv"``
where it names none) is ``reference/<name>.py``, the plain implementation
that decides ``correct`` (see ``load_reference``); the mix's ``drive`` is
``lib/<drive>.py``, the code that builds the program and runs the window
(see ``load_drive``).  Adding a cell, a configuration with its reference, a
mix with its drive, or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "torchpiv_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str):
    """The reader module of metric ``name``: ``metrics/<name>.py``, or, for a
    name ``<base>.<suffix>`` with no file of its own, ``metrics/<base>.py``
    (one quantity reported under a name of each cell kind)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(HERE, "metrics", f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modules(folder: str) -> List[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, folder))
                  if f.endswith(".py") and f != "__init__.py")


def _is_drive(name: str) -> bool:
    return getattr(importlib.import_module(f"{__package__}.{name}"), "DRIVE", False) is True


def load_reference(name: str):
    """The plain reference ``reference/<name>.py``: a module with
    ``settings(cfg)`` (the configuration with the reference's defaults;
    raises ``ValueError`` on a key whose semantics it does not compute) and
    ``run(frame_a, frame_b, cfg, precision)`` (``precision`` "float64", or
    "tf32" for the control), returning one pair's ``((x, y, u, v) or None,
    invalid)``."""
    present = _modules("reference")
    if name not in present:
        raise SystemExit(f"no reference {name!r}: the references present are {present}")
    return importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.reference.{name}")


def load_drive(name: str):
    """The drive ``lib/<name>.py``: a module that says ``DRIVE = True`` and
    has ``setup(cell, device, seconds, seed) -> state``, ``window(cell,
    state, seconds, seed, traced, on_open, on_close) -> out`` (the run's
    records, see ``Records``; ``out["harness_s"]``, where given, is set-up
    time that the harness spent on traffic of its own and that ``setup_s``
    leaves out) and ``teardown(state)``."""
    if name in _modules("lib") and _is_drive(name):
        return importlib.import_module(f"{__package__}.{name}")
    drives = [m for m in _modules("lib") if _is_drive(m)]
    raise SystemExit(f"no drive {name!r}: the drives present are {drives}")


class Cell:
    """A workload of ``BENCHMARK.json`` with its parts loaded."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.config = load_json(os.path.join(HERE, "configs", f"{self.entry['config']}.json"))
        self.traffic = load_json(os.path.join(HERE, "traffic", f"{self.entry['traffic']}.json"))
        self.limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))
        self.check_pairs = int(self.limits["check_pairs"])
        self.reference = load_reference(self.config.get("reference", "piv"))
        self.reference.settings(self.reference_config)
        self.drive = load_drive(self.traffic["drive"])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m, name) and m["moves"] in reported]
        self.frames = None

    @property
    def reference_config(self) -> dict:
        return {**self.config["engine"], "frame_shape": list(self.config["frame_shape"])}

    def shrink(self, frame_shape, unique_pairs: int, batch: int, check_pairs: int):
        """A smaller copy of the cell for the CPU tests: the frame, the pair
        count, the batch and the sample; nothing else changes."""
        self.config = {**self.config, "frame_shape": list(frame_shape), "batch": batch}
        self.traffic = {**self.traffic, "unique_pairs": unique_pairs}
        self.check_pairs = check_pairs
        self.limits = {**self.limits, "least_checked": check_pairs}


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Records:
    """What the metric readers read: the drive's records of the window
    (``out``, with its common keys as attributes), the trace's summary
    (traced runs), the cell and the device."""

    def __init__(self, cell: Cell, out: dict, setup_s: float, trace, kind: str):
        self.cell = cell
        self.out = out
        self.setup_s = setup_s
        self.fields = out["fields"]
        self.seconds = out["seconds"]
        self.spans = out.get("spans")
        self.tail_s = out.get("tail_s")
        self.span_log = out.get("span_log")
        self.trace = trace
        self.kind = kind


def run(name: str, seed: int, seconds: float, traced: bool, device: torch.device,
        t_start: float, bench: Optional[dict] = None,
        shrink: Optional[dict] = None) -> dict:
    """One run; returns the result line as a dict.  ``shrink`` (the CPU
    tests) makes the cell small."""
    from . import frames
    from .check import decide, report
    from .trace import Tracer, summarize

    cell = Cell(name, bench)
    if shrink:
        cell.shrink(**shrink)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, mix = cell.config, cell.traffic
    n = int(mix["unique_pairs"])
    if n % cfg["batch"]:
        raise SystemExit("unique_pairs must be a multiple of the batch")
    log(f"imports done at {time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    cell.frames = frames.pairs(n, tuple(cfg["frame_shape"]), mix, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    log(f"{n} pairs made in {time.perf_counter() - t:.2f} s")
    tracer = Tracer(cuda) if traced else None
    state = None
    try:
        if tracer is not None:
            tracer.__enter__()
        hooks = dict(on_open=tracer.open, on_close=tracer.close) if tracer else {}
        t = time.perf_counter()
        state = cell.drive.setup(cell, device, seconds, seed)
        log(f"drive {mix['drive']!r} set up in {time.perf_counter() - t:.2f} s")
        out = cell.drive.window(cell, state, seconds, seed, traced, **hooks)
    finally:
        if tracer is not None:
            tracer.__exit__(None, None, None)
        if state is not None:
            cell.drive.teardown(state)
    setup_s = out["t0"] - t_start - out.get("harness_s", 0.0)
    log(f"window: {out['fields']} fields in {seconds} s; set-up {setup_s:.3f} s "
        f"(the harness's own {out.get('harness_s', 0.0):.3f} s left out)")
    t = time.perf_counter()
    trace = summarize(tracer.events()) if tracer is not None else None
    if tracer is not None:
        log(f"trace read in {time.perf_counter() - t:.2f} s")
    tracer = None
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    rec = Records(cell, out, setup_s, trace, kind)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    samples = out.pop("samples")
    attempted, failed = out["attempted"], out["failed"]
    out = rec = None
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    correct, table, nums = decide(cell, samples)
    log(f"reference over {len(samples)} sampled pairs: {time.perf_counter() - t:.2f} s")
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak_bytes)}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if traced and trace is not None:
        device_info["busy_s"] = trace["busy_s"]
        device_info["window_s"] = trace["window_s"]
        line["breakdown"] = trace["breakdown"]
    line["check"] = table
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark may load none of "
                         f"{list(FORBIDDEN)}")
    log(f"run ends at {time.perf_counter() - t_start:.2f} s")
    report(table, nums)
    return line
