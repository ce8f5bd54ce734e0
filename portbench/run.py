#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix under ``portbench/``; the run makes
the mix's frames on the card from ``--seed``, builds and warms the
program (``torchpiv_tpu_torch``), measures for ``--seconds``, then checks a
seeded sample of the window's answers against the plain reference
(``portbench/reference/``).  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a ``torch.profiler``
trace of the window.  The last line of standard output is one JSON object;
the compared numbers, each beside its limit, are the last lines of
standard error.  Without a CUDA card it exits 2 and prints no result.

The kernels' build caches are kept inside the checkout, at fixed paths:
``portbench/.cache/build`` (``TORCHPIV_CACHE_DIR``) and
``portbench/.cache/triton`` (``TRITON_CACHE_DIR``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def cache_env() -> None:
    """Point the program's build caches into the checkout."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCHPIV_CACHE_DIR"] = os.path.join(cache, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    sys.path.insert(0, ROOT)
    import torch

    from portbench.lib.cell import Cell, load_json, run

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = Cell(args.workload, bench).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run(args.workload, args.seed, args.seconds, bool(args.trace),
               torch.device("cuda", 0), T_START, bench)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
