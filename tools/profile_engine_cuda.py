#!/usr/bin/env python3
"""Device time of the port's production dispatch by op kind on one CUDA
card: the counterpart of ``tools/profile_engine.py``.

    python tools/profile_engine_cuda.py [--mode cws|def|dws] [--passes 2]
                                        [--reps 3] [--top 40] [--device cpu]

Runs the headline configuration (4 MP pairs, w64/o32, ``--passes`` passes
of ``--mode``) at a batch of ``BATCH`` pairs staged on the device through
``pipeline.packed_forward``: a first call (its seconds to standard error),
two untraced dispatches (their ms, as the JAX tool's steady-state lines),
then ``torch.profiler`` with CUDA activity over a warm-up dispatch (a
trace can lose its first kernels) and, inside a ``record_function`` range
(``MARK``) bracketed by two CUDA events, ``--reps`` dispatches.  Only the
device-side events that start inside that range count (kernels, copies,
sets): an operator's host-side row repeats the time of the kernels it
launched, as the JAX trace's enclosing ``while`` span repeats its body's
ops, and neither is counted.  Events are grouped by ``classify``.

Prints the card's name and power limit first, then the device time over the
traced pairs and a pair's share of it, the groups (ms a pair) and the top
ops (ms a pair; a name cut at ``NAME_CHARS``: a kernel's demangled name
carries its template arguments), and the same dispatches' time between the
two CUDA events.
On the CPU the profiler's CPU operators stand in (no device events).
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME = (2048, 2048)
BATCH = 8
# the port's hand-written kernels, by the words of their names
HAND_WRITTEN = ("shift_windows", "def_windows", "peakfit", "corrfit", "fused_pass")
NAME_CHARS = 120  # a demangled kernel name is cut here in the report
MARK = "profiled dispatches"  # the range around the attributed dispatches


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def classify(name: str) -> str:
    """The group of a device event's name: the JAX tool's groups for CUDA
    names, the hand-written kernels under their own names.  The function's
    own name decides, not its template arguments (an elementwise kernel's
    functor may be called ``direct_copy_kernel_cuda``)."""
    n = name.lower().split("<")[0]
    for word in HAND_WRITTEN:
        if word in n:
            return word
    if "memcpy" in n and ("htod" in n or "dtoh" in n):
        return "transfer"
    if "memcpy" in n or "memset" in n or "copy" in n or "transpose" in n \
            or "roll_cuda" in n:
        return "layout_copy"
    if "fft" in n:
        return "fft"
    if "gemm" in n or "gemv" in n or "sm90" in n or "cutlass" in n:
        return "matmul"
    if "reduce" in n or "argmax" in n or "sort" in n or "scan" in n:
        return "reduce"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather_scatter"
    if "elementwise" in n or "vectorized" in n:
        return "fusion"
    return "other"


def staged(frame, batch, device, pairs=None):
    """``batch`` pairs on ``device``: 4 unique ``particle_pair``s (or
    ``pairs``), cycled, as the JAX tool stages them."""
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    if pairs is None:
        pairs = [particle_pair(frame, displacement=(3.3, -2.1), density=0.01, seed=i)
                 for i in range(4)]
    return tuple(torch.from_numpy(np.stack([pairs[i % len(pairs)][k]
                                            for i in range(batch)]))
                 .to(device) for k in (0, 1))


def profile_engine(device, mode="CWS", passes=2, reps=3, frame=FRAME, batch=BATCH,
                   engine_options=None, pairs=None) -> dict:
    """The attribution of ``reps`` dispatches (of ``pairs`` where given);
    returns ``per_group`` and
    ``per_op`` (device ms over all traced pairs), ``total_ms``,
    ``n_pairs``, ``event_ms`` (the CUDA events around the traced
    dispatches; None on the CPU), ``dispatch_ms`` (the two steady-state
    dispatches) and ``final_field_shape``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models.multipass import MultipassPIV
    from torchpiv_tpu_torch.pipeline import packed_forward

    cuda = device.type == "cuda"
    cfg = PIVConfig(frame_shape=tuple(frame), wind_size=64, overlap=32,
                    multipass=passes, multipass_mode=mode.upper(),
                    **(engine_options or {}))
    engine = MultipassPIV(cfg, device=device)
    fa, fb = staged(frame, batch, device, pairs)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    with torch.no_grad():
        t0 = time.perf_counter()
        packed_forward(engine, fa, fb)
        sync()
        log(f"compile+first: {time.perf_counter() - t0:.1f} s")
        dispatch_ms = []
        for _ in range(2):  # steady state, untraced
            t0 = time.perf_counter()
            packed_forward(engine, fa, fb)
            sync()
            dispatch_ms.append(1000 * (time.perf_counter() - t0))
            log(f"dispatch: {dispatch_ms[-1]:.1f} ms = {dispatch_ms[-1] / batch:.2f} ms/pair")
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            # a warm-up dispatch first: a trace can lose its first kernels
            packed_forward(engine, fa, fb)
            sync()
            with record_function(MARK):
                if cuda:
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                for _ in range(reps):
                    packed_forward(engine, fa, fb)
                if cuda:
                    end.record()
                sync()
    event_ms = start.elapsed_time(end) if cuda else None
    events = prof.events()
    t_mark = next(e for e in events if e.name == MARK).time_range.start
    # the events of the dispatches after the marker: device kernels, copies
    # and sets on the card; the operators' own time on the CPU
    times = collections.Counter()
    for e in events:
        if e.time_range.start < t_mark or e.name == MARK:
            continue
        if cuda and e.device_type == DeviceType.CUDA:
            times[e.name] += e.time_range.elapsed_us() / 1e3
        elif not cuda:
            times[e.name] += e.self_cpu_time_total / 1e3
    per_op = collections.Counter()
    per_group = collections.Counter()
    for name, ms in times.items():
        per_op[name] += ms
        per_group[classify(name)] += ms
    return {"per_group": per_group, "per_op": per_op, "total_ms": sum(times.values()),
            "n_pairs": reps * batch, "event_ms": event_ms, "dispatch_ms": dispatch_ms,
            "final_field_shape": tuple(engine.final_field_shape)}


def report(out: dict, top: int = 40) -> str:
    """The JAX tool's report of ``profile_engine``'s result."""
    npairs = out["n_pairs"]
    total = out["total_ms"]
    lines = [f"\n== device op time: {total:.1f} ms over {npairs} pairs "
             f"= {total / npairs:.2f} ms/pair ==", "\n-- by group (ms/pair) --"]
    lines += [f"{ms / npairs:8.3f}  {g}" for g, ms in out["per_group"].most_common()]
    lines.append(f"\n-- top {top} ops (ms/pair) --")
    lines += [f"{ms / npairs:8.3f}  {name if len(name) <= NAME_CHARS else name[:NAME_CHARS] + '...'}"
              for name, ms in out["per_op"].most_common(top)]
    if out["event_ms"] is not None:
        lines.append(f"\nCUDA events around the traced dispatches: {out['event_ms']:.1f} ms "
                     f"= {out['event_ms'] / npairs:.2f} ms/pair")
    return "\n".join(lines)


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device
    from torchpiv_tpu_torch.utils.scripts import add_device_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="CWS")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3, help="traced dispatches")
    ap.add_argument("--top", type=int, default=40)
    args = add_device_args(ap).parse_args(argv)
    device, card = script_device(args.device)
    print(card, flush=True)
    out = profile_engine(device, args.mode, args.passes, args.reps, FRAME, BATCH,
                         engine_options={"use_pallas": args.use_pallas})
    print(report(out, args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
