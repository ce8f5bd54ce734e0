#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's compared numbers and
the control's, on many seeds in one process.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 ... [--out FILE]

For each seed the cell's frames are made as a run makes them; ``check_pairs``
of them, drawn from the seed, go through the program's timed entry
(``pipeline.packed_forward`` at the cell's batch, then ``pipeline.tail_of``)
and through the reference twice: in float64 (the yardstick) and as the
control, in float32 with every matrix product's operands rounded to TF32
(the nearest precision below the configuration's float32 with TF32 off).
Both the program's and the control's answers are held against the float64
reference by the numbers of ``lib/check.py``.  One JSON line a seed goes to
standard output (and to ``--out``).  The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed: int, device) -> dict:
    """The program's and the control's numbers for one seed."""
    import torch

    from portbench.lib import frames
    from portbench.lib.check import numbers, reference_answers
    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models.multipass import MultipassPIV
    from torchpiv_tpu_torch.pipeline import packed_forward, tail_of

    cfg, mix = cell.config, cell.traffic
    n = int(mix["unique_pairs"])
    cell.frames = frames.pairs(n, tuple(cfg["frame_shape"]), mix, seed, device)
    fa, fb = cell.frames
    B = cfg["batch"]
    pick = sorted(random.Random(seed).sample(range(n), cell.check_pairs))
    engine = MultipassPIV(PIVConfig(frame_shape=tuple(cfg["frame_shape"]),
                                    **cfg["engine"]), device=device)
    tail = tail_of(engine, 1.0, 1.0)
    program = []
    with torch.no_grad():
        for s in range(0, len(pick), B):
            idx = torch.tensor(pick[s:s + B], device=device)
            packed = packed_forward(engine, fa[idx], fb[idx]).cpu().numpy()
            for j, k in enumerate(pick[s:s + B]):
                program.append({"pair": k, "invalid": packed[j, 2] > 0.5,
                                "field": tail(packed[j, 0], packed[j, 1], packed[j, 2] > 0.5)})
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = reference_answers(cell.frames, pick, cell.reference_config, "float64")
    ref_s = time.perf_counter() - t
    low = reference_answers(cell.frames, pick, cell.reference_config, "tf32")
    control = [{"pair": k, "field": low[k][0], "invalid": low[k][1]} for k in pick]
    out = {"seed": seed, "pairs": pick, "reference_s": ref_s,
           "program": numbers(program, want, cell.reference_config),
           "control": numbers(control, want, cell.reference_config)}
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
