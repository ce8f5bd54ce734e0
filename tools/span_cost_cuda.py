#!/usr/bin/env python3
"""What the engine's stage spans cost, and what they read, on one CUDA card.

    python tools/span_cost_cuda.py [--mode cws|def] [--batch 32] [--blocks 4]
                                   [--calls 8] [--out FILE]

Builds the engine of a 4 MP pair (``--mode cws``: w64/o32, two CWS passes;
``def``: w64/o48, three DEF passes to 16 px windows at 75% overlap) over
``--batch`` staged particle pairs, warms it, then runs ``--blocks`` blocks
of ``--calls`` dispatches (``pipeline.packed_forward``) in three settings,
in turns (A B C C B A ...):

* ``off``: no profiler (the spans' no-op path);
* ``profiler``: ``torch.profiler`` with CPU and CUDA activity, the spans
  replaced by the no-op context (the profiler's own cost);
* ``spans``: the same profiler with the spans recording.

Each dispatch is timed by two CUDA events on the stream around it (device
ms a batch) and by the host clock (issue ms).  Reports each setting's
medians and means; the stage split of the recorded calls (device ms a pair
by span and by stage, their sum, and the calls' own ``piv.call`` spans,
against the ``spans`` setting's mean from the outside events, which time
the same calls); the flagged share; and the clock check: for spans opened
under the profiler, ``time.time_ns()`` at a span's start against the
profiler's event for its range (µs after the event's start, and from it to
the event's end; both >= 0 when the record lies inside the event).  Prints
the card's name and power limit first; ``--out`` also writes the JSON report.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME = (2048, 2048)
MODES = {
    "cws": dict(wind_size=64, overlap=32, multipass=2, multipass_mode="CWS"),
    "def": dict(wind_size=64, overlap=48, multipass=3, multipass_mode="DEF"),
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def frames(batch, device):
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    pairs = [particle_pair(FRAME, (3.3, -2.1), seed=s) for s in range(4)]
    a = np.stack([pairs[i % 4][0] for i in range(batch)])
    b = np.stack([pairs[i % 4][1] for i in range(batch)])
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def spans_off():
    """Swap the engine's spans for the no-op context; returns the undo."""
    from torchpiv_tpu_torch.models import multipass
    from torchpiv_tpu_torch.utils import profiling

    saved = (multipass.span, multipass.engine_call, multipass.count)
    multipass.span = lambda name: profiling.OFF
    multipass.engine_call = lambda *args: profiling.OFF
    multipass.count = lambda *args: None

    def undo():
        multipass.span, multipass.engine_call, multipass.count = saved
    return undo


def block(engine, a, b, calls):
    """``calls`` dispatches: (device ms, issue ms) each."""
    from torchpiv_tpu_torch.pipeline import packed_forward

    out = []
    for _ in range(calls):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        t = time.perf_counter()
        packed_forward(engine, a, b)
        issue = 1000 * (time.perf_counter() - t)
        ev[1].record()
        out.append((ev, issue))
    torch.cuda.synchronize()
    return [(e[0].elapsed_time(e[1]), i) for e, i in out]


def clock_check(n=20):
    """``time.time_ns()`` offsets of spans against their profiler events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchpiv_tpu_torch.utils import profiling

    x = torch.ones(1 << 20, device="cuda")
    got = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with profiling.span(f"clock.{i}") as s:
                x.mul_(1.0)
            got[f"clock.{i}"] = (s.start, time.time_ns())
    offs = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in got and e.device_type() == DeviceType.CPU:
            s0, _ = got[e.name()]
            offs.append(((s0 - e.start_ns()) / 1e3,
                         (e.start_ns() + e.duration_ns() - s0) / 1e3))
    return {"n": len(offs),
            "start_after_event_start_us": sorted(o[0] for o in offs),
            "event_end_after_start_us": sorted(o[1] for o in offs)}


def split(records):
    """Device ms a pair by span name, and the sums."""
    pairs = sum(r.pairs for r in records)
    by = {}
    for r in records:
        for s in r.spans:
            by[s.name] = by.get(s.name, 0.0) + s.device_ms
    stages = {}
    for name, ms in by.items():
        stage = name.rsplit(".", 1)[-1]
        stage = "fields" if stage in ("input", "predict", "guard", "post") else stage
        stages[stage] = stages.get(stage, 0.0) + ms
    return {"by_span": {k: v / pairs for k, v in by.items()},
            "by_stage": {k: v / pairs for k, v in stages.items()},
            "stage_sum": sum(by.values()) / pairs,
            "call": sum(r.call.device_ms for r in records) / pairs,
            "flagged_pct": 100.0 * sum(r.counts["flagged"] for r in records)
            / sum(r.vectors for r in records),
            "calls": len(records)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=sorted(MODES), default="cws")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 2
    from torch.profiler import ProfilerActivity, profile

    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models.multipass import MultipassPIV
    from torchpiv_tpu_torch.pipeline import packed_forward
    from torchpiv_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    report = {"card": card(), "mode": args.mode, "batch": args.batch,
              "clock": clock_check()}
    engine = MultipassPIV(PIVConfig(frame_shape=FRAME, **MODES[args.mode]), device="cuda")
    a, b = frames(args.batch, "cuda")
    with torch.no_grad():
        for _ in range(3):
            packed_forward(engine, a, b)
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        times = {"off": [], "profiler": [], "spans": []}
        order = ["off", "profiler", "spans"]
        records = []
        for k in range(args.blocks):
            for setting in (order if k % 2 == 0 else order[::-1]):
                if setting == "off":
                    times[setting] += block(engine, a, b, args.calls)
                    continue
                undo = spans_off() if setting == "profiler" else None
                n0 = len(profiling.calls())
                try:
                    with profile(activities=acts):
                        # a trace can lose a dispatch's first kernels
                        packed_forward(engine, a, b)
                        torch.cuda.synchronize()
                        times[setting] += block(engine, a, b, args.calls)
                finally:
                    if undo is not None:
                        undo()
                if setting == "spans":
                    records += profiling.calls()[n0 + 1:]
    B = args.batch
    report["per_setting"] = {
        s: {"device_ms_per_pair": statistics.median(d for d, _ in v) / B,
            "device_ms_per_pair_mean": statistics.mean(d for d, _ in v) / B,
            "issue_ms_per_batch": statistics.median(i for _, i in v),
            "device_ms_per_pair_all": [d / B for d, _ in v]}
        for s, v in times.items()}
    report["split"] = split(records)
    print(json.dumps(report, indent=1), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
