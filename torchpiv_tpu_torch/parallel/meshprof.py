"""Window-split overhead profile (counterpart of
``torchpiv_tpu/parallel/meshprof.py``).

The window split of ``parallel.sharded.ShardedPIV`` splits the window-grid
rows across a mesh axis; its overheads against a single-device run are:

* **duplicated tail rows** — clamped contiguous blocks mean the last
  shard recomputes rows already owned by its neighbour whenever the row
  count does not divide the axis size (``_block_layout``);
* **the per-pass gather** — the spline predictor upsample needs the full
  coarse field, so each pass gathers tiny ``[R, C]`` float32 fields (the
  only cross-shard step in the engine);
* **replicated frame work** — each device holds the full frames;
* **more launches** — every kernel of a pass runs once a shard.

:func:`profile` measures 1/2/4/..-way window splits back to back in one
process over a device list the caller gives, and reports per-split step
times plus the analytic overhead terms.  On one card that list is
``[cuda:0] * nw``: the shards then run one after another on the same card,
so the table shows the cost of the split (more, smaller launches, the
duplicated rows and the gathers), never a multi-device speed-up.  Times are
CUDA events on a card and the host clock on the CPU.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def _dup_row_fraction(R: int, nw: int) -> float:
    """Fraction of window rows recomputed by clamped blocks."""
    rloc = min(-(-R // nw), R)
    return (nw * rloc - R) / R


def _timer(dev: torch.device, reps: int) -> Callable:
    """``timeit(fn)``: the best of ``reps`` runs of ``fn`` after one warm-up
    run, in ms (CUDA events on the current stream of a CUDA ``dev``, the
    host clock otherwise)."""

    def timeit(fn) -> float:
        fn()
        best = float("inf")
        for _ in range(reps):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                best = min(best, (time.perf_counter() - t0) * 1000.0)
        return best

    return timeit


def profile(
    frame_shape=(1024, 1024),
    wind_size: int = 64,
    overlap: int = 32,
    multipass: int = 2,
    splits: Optional[List[int]] = None,
    reps: int = 3,
    log=print,
    devices: Optional[Sequence] = None,
    batch: int = 1,
) -> List[dict]:
    """Window-split overhead table over ``devices`` (default: every CUDA
    device; on one card pass ``[torch.device("cuda", 0)] * 4``).

    Returns one dict per split: ``{nw, ms, vs_1way, dup_rows_pct,
    gather_ms, gather_bytes}``; ``log`` receives aligned table rows.
    ``ms`` is a step of ``batch`` pairs; ``gather_bytes`` counts one pair.
    """
    from ..models.multipass import MultipassPIV, PIVConfig
    from ..utils.synthetic import particle_pair
    from .mesh import _cuda_devices, _indexed, make_mesh
    from .sharded import ShardedPIV

    devices = [_indexed(torch.device(d)) for d in (devices if devices is not None
                                                   else _cuda_devices())]
    dev0 = devices[0]
    if splits is None:
        splits = [s for s in (1, 2, 4, 8) if s <= len(devices)]

    cfg = PIVConfig(frame_shape=tuple(frame_shape), wind_size=wind_size,
                    overlap=overlap, multipass=multipass,
                    multipass_mode="CWS")
    engine = MultipassPIV(cfg, device=dev0)
    fa, fb = particle_pair(tuple(frame_shape), displacement=(3.3, -2.1),
                           density=0.008, seed=11)
    fa = torch.from_numpy(np.stack([fa] * batch)).to(dev0)
    fb = torch.from_numpy(np.stack([fb] * batch)).to(dev0)
    timeit = _timer(dev0, reps)

    # per-pass gather payload: u, v, inval as f32 on each pass's grid
    gather_bytes = sum(4 * 3 * r * c for r, c in engine.field_shapes)

    rows = []
    base_ms = None
    log("| windows-split | step ms (best of %d) | vs 1-way | dup rows %% | "
        "gather ms | gather bytes/pair |" % reps)
    log("|---|---|---|---|---|---|")
    for nw in splits:
        if nw == 1:
            ms = timeit(lambda: engine(fa, fb))
        else:
            mesh = make_mesh({"pairs": 1, "windows": nw}, devices[:nw])
            sharded = ShardedPIV(engine, mesh)
            ms = timeit(lambda: sharded(fa, fb))
        if base_ms is None:
            base_ms = ms

        gather_ms = 0.0
        if nw > 1:
            # the gathers alone, in the engine's pattern (each pass's
            # [B, rloc, C] blocks of u, v and inval to the devices of the
            # split, stacked, concatenated and reordered), with no pass
            # around them
            blocks = []
            for r, c in engine.field_shapes:
                rloc = min(-(-r // nw), r)
                blocks.append([tuple(torch.zeros((batch, rloc, c), dtype=t,
                                                 device=sharded.devices[0, j])
                                     for t in (torch.float32, torch.float32, torch.bool))
                               for j in range(nw)])

            def gather_all():
                for p, bl in enumerate(blocks):
                    for dev in dict.fromkeys(sharded.devices[0]):
                        sharded._gather_full(bl, p, dev)

            gather_ms = timeit(gather_all)

        dup = max(_dup_row_fraction(r, nw) for r, _ in engine.field_shapes) * 100.0
        rows.append(dict(nw=nw, ms=ms, vs_1way=ms / base_ms, dup_rows_pct=dup,
                         gather_ms=gather_ms, gather_bytes=gather_bytes))
        log(f"| {nw} | {ms:.3f} | {ms / base_ms:.3f}x | {dup:.1f} | "
            f"{gather_ms:.4f} | {gather_bytes} |")
    return rows
