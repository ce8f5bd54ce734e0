#!/usr/bin/env python3
"""Per-configuration engine pace on one CUDA card, in one process: the
counterpart of ``tools/bench_sweep.py``.

    python tools/bench_sweep_cuda.py [--device cpu] [--use-pallas off]
    BENCH_SWEEP_REPS=5 python tools/bench_sweep_cuda.py

Times the production dispatch as ``OfflinePIV`` runs it,
``pipeline.packed_forward`` (the engine over a ``[B, H, W]`` batch, packed
into one ``[B, 3, R, C]`` tensor; the JAX tool's ``build_packed_scan``),
for each configuration of ``CONFIGS`` back to back in one process, on
``BENCH_SWEEP_BATCH`` pairs staged on the device (4 unique
``particle_pair(FRAME, (3.3, -2.1), density=0.01, seed=i)`` pairs, cycled).
A rep is one dispatch between two ``torch.cuda.synchronize``; a row gives
the median of ``BENCH_SWEEP_REPS``.  "compile+first" is the first call's
seconds: the kernels' load (their ``nvcc`` build where the build directory
lacks them, ``kernels._build.load_log``), cuFFT's plans and the caching
allocator's first blocks.  A configuration that fails prints ``FAILED`` and
the sweep goes on.  Then, unless ``BENCH_SWEEP_BATCHES=0``, the headline
configuration (w64/o32, 2-pass CWS) at batches 4, 8, 16 and 32.

Prints the card's name and power limit first, one line a configuration,
and the JAX tool's two markdown tables.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import torch  # noqa: E402

FRAME = (2048, 2048)
BATCH = int(os.environ.get("BENCH_SWEEP_BATCH", 8))
REPS = int(os.environ.get("BENCH_SWEEP_REPS", 3))
BATCHES = (4, 8, 16, 32)  # the batch sweep of the headline configuration
HEADLINE = dict(wind_size=64, overlap=32, multipass=2, multipass_mode="CWS")

# (label, config overrides): the JAX tool's list.  The reference's published
# configuration is w64/50%/2-pass CWS (TorchPIV README); w32 is the
# high-density final grid; DEF is the deforming-window mode.
CONFIGS = [
    ("w32 o16 2xCWS", dict(wind_size=32, overlap=16, multipass=2,
                           multipass_mode="CWS")),
    ("w64 o32 2xCWS", dict(wind_size=64, overlap=32, multipass=2,
                           multipass_mode="CWS")),
    ("w64 o32 2xDWS", dict(wind_size=64, overlap=32, multipass=2,
                           multipass_mode="DWS")),
    ("w64 o32 2xDEF", dict(wind_size=64, overlap=32, multipass=2,
                           multipass_mode="DEF")),
    ("w128 o64 2xCWS", dict(wind_size=128, overlap=64, multipass=2,
                            multipass_mode="CWS")),
    ("w64 o32 3xCWS", dict(wind_size=64, overlap=32, multipass=3,
                           multipass_mode="CWS")),
]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def unique_pairs(frame, n: int = 4) -> list:
    """The sweep's unique pairs, as the JAX tool makes them."""
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    return [particle_pair(frame, displacement=(3.3, -2.1), density=0.01, seed=i)
            for i in range(n)]


def stage(pairs, batch: int, device):
    """``batch`` pairs (the unique ones cycled) as two ``[B, H, W]``
    tensors on ``device``."""
    import numpy as np

    return tuple(torch.from_numpy(np.stack([pairs[i % len(pairs)][k]
                                            for i in range(batch)])).to(device)
                 for k in (0, 1))


def build(overrides: dict, device, frame=FRAME, engine_options=None):
    """The engine of one configuration on ``device``."""
    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models.multipass import MultipassPIV

    cfg = PIVConfig(frame_shape=tuple(frame), **overrides, **(engine_options or {}))
    return MultipassPIV(cfg, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_dispatch(engine, fa, fb, reps: int) -> dict:
    """The first call's seconds (with the kernels it loaded) and the median
    of ``reps`` timed dispatches; returns the packed first result too."""
    from torchpiv_tpu_torch.kernels import _build
    from torchpiv_tpu_torch.pipeline import packed_forward

    device = fa.device
    loaded = set(_build.load_log())
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        out = packed_forward(engine, fa, fb)
        _sync(device)
        first_s = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            packed_forward(engine, fa, fb)
            _sync(device)
            times.append(time.perf_counter() - t0)
    new = {k: v for k, v in _build.load_log().items() if k not in loaded}
    return {"median_s": sorted(times)[len(times) // 2], "first_s": first_s,
            "kernel_loads": new, "out": out}


def sweep_configs(device, configs=CONFIGS, batch=BATCH, reps=REPS, frame=FRAME,
                  pairs=None, engine_options=None) -> list:
    """One row a configuration, printed as it is timed: ``label``,
    ``ms_pair``, ``pairs_s``, ``grid`` (the output's ``(R, C)``),
    ``final_field_shape`` (the engine's), ``compile_first_s`` and
    ``kernel_loads``; a failed configuration gives ``{"label", "error"}``."""
    pairs = pairs if pairs is not None else unique_pairs(frame)
    fa, fb = stage(pairs, batch, device)
    rows = []
    for label, overrides in configs:
        try:
            engine = build(overrides, device, frame, engine_options)
            t = time_dispatch(engine, fa, fb, reps)
            grid = tuple(t["out"].shape[-2:])
            row = {"label": label, "ms_pair": 1000 * t["median_s"] / batch,
                   "pairs_s": batch / t["median_s"], "grid": grid,
                   "final_field_shape": tuple(engine.final_field_shape),
                   "compile_first_s": t["first_s"], "kernel_loads": t["kernel_loads"]}
            rows.append(row)
            print(f"{label:16s} {row['ms_pair']:7.2f} ms/pair "
                  f"{row['pairs_s']:7.1f} pairs/s  grid {grid[0]}x{grid[1]} "
                  f"(compile+first {t['first_s']:.1f}s)", flush=True)
            del engine, t
        except Exception as e:  # keep sweeping on a single-configuration failure
            rows.append({"label": label, "error": repr(e)})
            print(f"{label:16s} FAILED: {e!r}", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def sweep_batches(device, batches=BATCHES, reps=REPS, frame=FRAME, pairs=None,
                  engine_options=None) -> list:
    """The headline configuration at each batch: rows of ``batch``,
    ``ms_pair`` and ``pairs_s``, printed as the JAX tool's table rows."""
    pairs = pairs if pairs is not None else unique_pairs(frame)
    engine = build(HEADLINE, device, frame, engine_options)
    rows = []
    for b in batches:
        fa, fb = stage(pairs, b, device)
        t = time_dispatch(engine, fa, fb, reps)
        rows.append({"batch": b, "ms_pair": 1000 * t["median_s"] / b,
                     "pairs_s": b / t["median_s"]})
        print(f"| {b} | {rows[-1]['ms_pair']:.2f} | {rows[-1]['pairs_s']:.1f} |",
              flush=True)
        del fa, fb, t
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def config_table(rows) -> str:
    lines = ["| config | ms/pair | pairs/s | vector grid |", "|---|---|---|---|"]
    for r in rows:
        if "error" not in r:
            lines.append(f"| {r['label']} | {r['ms_pair']:.2f} | {r['pairs_s']:.1f} | "
                         f"{r['grid'][0]}x{r['grid'][1]} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device
    from torchpiv_tpu_torch.utils.scripts import add_device_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args = add_device_args(ap).parse_args(argv)
    device, card = script_device(args.device)
    print(card, flush=True)
    log(f"device {device}  frame={FRAME} batch={BATCH} reps={REPS}")
    options = {"use_pallas": args.use_pallas}
    pairs = unique_pairs(FRAME)
    rows = sweep_configs(device, CONFIGS, BATCH, REPS, FRAME, pairs, options)
    print("\n" + config_table(rows))
    # how much per-dispatch overhead remains at each batch (same engine,
    # same process)
    if os.environ.get("BENCH_SWEEP_BATCHES", "1") != "0":
        print("\n| scan batch | ms/pair | pairs/s |")
        print("|---|---|---|")
        sweep_batches(device, BATCHES, REPS, FRAME, pairs, options)
    return 0


if __name__ == "__main__":
    sys.exit(main())
