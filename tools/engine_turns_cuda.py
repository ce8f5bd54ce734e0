#!/usr/bin/env python3
"""Device time a batch of the port's engines for two checkouts of the
repository, in turns on one card: A, B, B, A, one process a turn.

    python3 tools/engine_turns_cuda.py A_DIR B_DIR

A checkout is a directory holding ``chip_smoke.py`` and
``torchpiv_tpu_torch/`` (for example the parent commit unpacked by ``git
archive`` into a directory that ``.gitignore`` lists).  Each turn builds
that checkout's kernels and profiles, twice each, one batch of 4 pairs of
2048² frames through five engines (w64/o32, 2 passes) with its own
``chip_smoke.phase_profile``: ``CWS`` (the main path), ``CWS bicubic``
(``cws_interp="bicubic"``, sheared pairs), ``robust`` (the robust
configuration with ``shift_variant="phases"``, corrupted pairs and the wall
mask), ``DEF peakfit=pallas`` (sheared pairs, the fused peak fit), ``CWS
bf16`` (``shift_variant="bf16"``) and ``CWS lanephases``
(``shift_variant="lanephases"``).  The pairs are written once, by this
checkout's ``chip_smoke.py``, into a temporary directory that every turn
reads.  Two calls may land on two cards: compare the two checkouts only
within one run of this tool.

Prints the card's name and power limit first, then one line a turn and
engine (device ms a batch from ``torch.profiler``, the share of the window
shifts and of the peak fit in it, the engine's ms a batch by CUDA events,
the host's issue ms of a batch with nothing else running, and its peak
device memory), then JSON lines of the medians of the device ms and of the
issue ms by checkout and engine.  Exits with 1 without a card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
ENGINES = ("CWS", "CWS bicubic", "robust", "DEF peakfit=pallas", "CWS bf16",
           "CWS lanephases")


def write_pairs(folder: str) -> None:
    """One batch of uniform, sheared and corrupted pairs into ``folder``."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from torchpiv_tpu_torch.utils.synthetic import shear_flow

    uniform = os.path.join(folder, "uniform")
    cs.write_pairs(uniform, cs.BATCH, cs.DISPLACEMENT, seed=100)
    cs.write_pairs(os.path.join(folder, "shear"), cs.BATCH, shear_flow(*cs.SHEAR),
                   seed=200)
    cs.write_rough_pairs(uniform, os.path.join(folder, "rough"), seed=300)


def turn(tree: str, folder: str) -> dict:
    """Profile every engine twice with ``tree``'s own code (run in a process
    of its own); ``{engine: [profile, profile]}``."""
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs
    from torchpiv_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    configs = {"CWS": ("uniform", {}),
               "CWS bicubic": ("shear", {"cws_interp": "bicubic"}),
               "robust": ("rough", {"frame_mask": cs.wall_mask(),
                                    "shift_variant": "phases", **cs.ROBUST}),
               "DEF peakfit=pallas": ("shear", {"multipass_mode": "DEF",
                                                "peakfit": "pallas"}),
               "CWS bf16": ("uniform", {"shift_variant": "bf16"}),
               "CWS lanephases": ("uniform", {"shift_variant": "lanephases"})}
    out = {}
    for _ in range(2):
        for engine in ENGINES:
            sub, kw = configs[engine]
            p = cs.phase_profile(os.path.join(folder, sub), engine, **kw)
            out.setdefault(engine, []).append({
                "device_ms": p["device_ms"], "ms_batch": p["ms_batch"],
                "issue_ms": p["issue_ms"],
                "peak_bytes": p["peak_bytes"],
                "shift_ms": sum(t for k, t in p["kernels"].items()
                                if "shift_windows" in k or "phase_table" in k),
                "peakfit_ms": sum(t for k, t in p["kernels"].items()
                                  if "peakfit" in k)})
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--turn":
        print("TURN " + json.dumps(turn(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("engine_turns_cuda: no CUDA device", file=sys.stderr)
        return 1
    a, b = sys.argv[1:3]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    readings = {a: {e: [] for e in ENGINES}, b: {e: [] for e in ENGINES}}
    with tempfile.TemporaryDirectory(prefix="engine_turns_") as folder:
        write_pairs(folder)
        for tree in (a, b, b, a):
            run = subprocess.run([sys.executable, __file__, "--turn", tree, folder],
                                 capture_output=True, text=True, check=True)
            line = [ln for ln in run.stdout.splitlines() if ln.startswith("TURN ")][-1]
            for engine, profiles in json.loads(line[5:]).items():
                for p in profiles:
                    readings[tree][engine].append(p)
                    print(f"{tree} {engine}: device {p['device_ms']:.3f} ms a batch "
                          f"(window shifts {p['shift_ms']:.3f}, peak fit "
                          f"{p['peakfit_ms']:.3f}), engine "
                          f"{p['ms_batch']:.3f} ms, issue {p['issue_ms']:.3f} ms, "
                          f"peak {p['peak_bytes']} B", flush=True)
    for key in ("device_ms", "issue_ms"):
        print(json.dumps({key: {tree: {e: statistics.median(p[key] for p in ps)
                                       for e, ps in by_engine.items()}
                                for tree, by_engine in readings.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
