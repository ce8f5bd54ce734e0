#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's compared numbers and
the control's, on many seeds in one process.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 ... [--out FILE]

For each seed the cell's frames are made as a run makes them, and the
cell's drive (``lib/<drive>.py``) sets the program up and runs a short
window of ``WINDOW_S`` seconds at the cell's own load; the
``check_pairs`` answers it samples from the seed go, with their pairs,
through the cell's reference (``reference/<name>.py``) twice: in float64
(the yardstick) and as the control, in float32 with every matrix
product's operands rounded to TF32 (the nearest precision below the
configuration's float32 with TF32 off).  Both the program's and the
control's answers are held against the float64 reference by the numbers
of ``lib/check.py``.  One JSON line a seed goes to standard output (and to
``--out``).  The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WINDOW_S = 2.0


def readings(cell, seed: int, device, seconds: float = WINDOW_S) -> dict:
    """The program's and the control's numbers for one seed."""
    import torch

    from portbench.lib import frames
    from portbench.lib.check import numbers, reference_answers

    cfg, mix = cell.config, cell.traffic
    n = int(mix["unique_pairs"])
    cell.frames = frames.pairs(n, tuple(cfg["frame_shape"]), mix, seed, device)
    state = cell.drive.setup(cell, device, seconds, seed)
    try:
        program = cell.drive.window(cell, state, seconds, seed, False)["samples"]
    finally:
        cell.drive.teardown(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pick = sorted({s["pair"] for s in program})
    ref, rcfg = cell.reference, cell.reference_config
    t = time.perf_counter()
    want = reference_answers(ref, cell.frames, pick, rcfg, "float64")
    ref_s = time.perf_counter() - t
    low = reference_answers(ref, cell.frames, pick, rcfg, "tf32")
    control = [{"pair": s["pair"], "field": low[s["pair"]][0], "invalid": low[s["pair"]][1]}
               for s in program]
    out = {"seed": seed, "pairs": [s["pair"] for s in program], "reference_s": ref_s,
           "program": numbers(ref, program, want, rcfg),
           "control": numbers(ref, control, want, rcfg)}
    cell.frames = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.run import cache_env

    cache_env()
    import torch

    from portbench.lib.cell import Cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        line = json.dumps(readings(cell, seed, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
