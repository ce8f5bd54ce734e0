"""Frame conditioning for difficult recordings (numpy; copy of
``torchpiv_tpu/io/preprocess.py``).

The engine's per-window mean normalisation removes local DC offsets, but
strongly uneven illumination / low contrast still starves the correlation
peak.  Standard PIV conditioning steps (cf. PIVlab's pre-processing panel;
the reference has none):

* **CLAHE** — contrast-limited adaptive histogram equalisation (Zuiderveld
  1994): per-tile clipped histogram CDF LUTs, bilinearly blended between
  tiles.  The workhorse for reflections / laser-sheet falloff.
* **percentile stretch** — global contrast stretch between intensity
  percentiles (robust min/max normalisation).

Host-side numpy, applied inside the prefetcher's decode threads
(``PreprocessedPairs``) so it overlaps with device compute.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def clahe(
    frame: np.ndarray,
    tiles: int = 8,
    clip_limit: float = 2.0,
) -> np.ndarray:
    """CLAHE on a uint8 grayscale frame; returns uint8.

    ``tiles`` is the grid size per axis (8x8 default); ``clip_limit``
    caps each tile histogram at ``clip_limit * tile_pixels / 256`` with
    the clipped excess redistributed uniformly (limits noise
    amplification in flat regions).
    """
    f = np.asarray(frame)
    if f.dtype != np.uint8:
        raise ValueError("clahe expects a uint8 frame")
    H, W = f.shape
    th = -(-H // tiles)
    tw = -(-W // tiles)
    nty = -(-H // th)
    ntx = -(-W // tw)

    luts = np.empty((nty, ntx, 256), dtype=np.float32)
    for ty in range(nty):
        for tx in range(ntx):
            tile = f[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
            hist = np.bincount(tile.ravel(), minlength=256).astype(np.float64)
            clip = max(clip_limit * tile.size / 256.0, 1.0)
            excess = np.maximum(hist - clip, 0.0).sum()
            hist = np.minimum(hist, clip) + excess / 256.0
            cdf = hist.cumsum()
            lo = cdf[int(tile.min())] if tile.size else 0.0
            span = max(cdf[-1] - lo, 1e-12)
            luts[ty, tx] = np.clip((cdf - lo) / span * 255.0, 0.0, 255.0)

    # bilinear blend of the four surrounding tile LUTs at every pixel
    fy = (np.arange(H, dtype=np.float32) + 0.5) / th - 0.5
    fx = (np.arange(W, dtype=np.float32) + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, nty - 1)
    x0 = np.clip(np.floor(fx).astype(np.int64), 0, ntx - 1)
    y1 = np.minimum(y0 + 1, nty - 1)
    x1 = np.minimum(x0 + 1, ntx - 1)
    wy = np.clip(fy - y0, 0.0, 1.0).astype(np.float32)[:, None]
    wx = np.clip(fx - x0, 0.0, 1.0).astype(np.float32)[None, :]

    v = f.astype(np.int64)
    out = ((1 - wy) * (1 - wx) * luts[y0[:, None], x0[None, :], v]
           + (1 - wy) * wx * luts[y0[:, None], x1[None, :], v]
           + wy * (1 - wx) * luts[y1[:, None], x0[None, :], v]
           + wy * wx * luts[y1[:, None], x1[None, :], v])
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def percentile_stretch(
    frame: np.ndarray,
    low: float = 1.0,
    high: float = 99.0,
) -> np.ndarray:
    """Robust global contrast stretch: map the [low, high] intensity
    percentiles onto [0, 255], saturating outside; returns uint8."""
    f = np.asarray(frame).astype(np.float32)
    lo, hi = np.percentile(f, [low, high])
    if hi <= lo:
        return np.asarray(frame, dtype=np.uint8)
    out = (f - lo) / (hi - lo) * 255.0
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def resolve_preprocess(spec) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """Map a ``preprocess`` option to a frame->frame callable.

    ``None``/``"none"`` -> None; ``"clahe"`` / ``"stretch"`` -> the
    functions above with defaults; a callable passes through.
    """
    if spec in (None, "none"):
        return None
    if callable(spec):
        return spec
    if spec == "clahe":
        return clahe
    if spec == "stretch":
        return percentile_stretch
    raise ValueError(f"unknown preprocess option {spec!r}; expected "
                     "'none', 'clahe', 'stretch', or a callable")


class PreprocessedPairs:
    """Dataset adapter applying a frame preprocessing function to both
    frames of each pair (runs inside the prefetcher's decode threads, so
    it overlaps with device compute)."""

    def __init__(self, dataset, fn: Callable[[np.ndarray], np.ndarray]):
        self.dataset = dataset
        self.fn = fn

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        fa, fb = self.dataset[i]
        if fa is None or fb is None:
            return fa, fb
        return self.fn(fa), self.fn(fb)
