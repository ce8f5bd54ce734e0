"""Synthetic PIV image pairs with known displacement (numpy).

Copy of ``render_particles``, ``particle_pair`` and ``shear_flow`` from
``torchpiv_tpu/utils/synthetic.py``: random Gaussian particles rendered
into frame A, advected by a prescribed flow, and re-rendered into frame B.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def render_particles(
    shape: Tuple[int, int],
    xs: np.ndarray,
    ys: np.ndarray,
    intensity: np.ndarray,
    diameter: float = 2.5,
) -> np.ndarray:
    """Render Gaussian particle images onto a float frame (additive)."""
    H, W = shape
    frame = np.zeros((H, W), dtype=np.float32)
    sigma = diameter / 2.354  # FWHM -> sigma
    r = max(2, int(np.ceil(3 * sigma)))
    span = np.arange(-r, r + 1)

    cx = np.round(xs).astype(np.int64)
    cy = np.round(ys).astype(np.int64)
    fx = xs - cx
    fy = ys - cy

    # Per-particle separable Gaussian stamps accumulated with add.at.
    gx = np.exp(-((span[None, :] - fx[:, None]) ** 2) / (2 * sigma**2))
    gy = np.exp(-((span[None, :] - fy[:, None]) ** 2) / (2 * sigma**2))
    stamps = intensity[:, None, None] * gy[:, :, None] * gx[:, None, :]

    iy = cy[:, None] + span[None, :]
    ix = cx[:, None] + span[None, :]
    ok = (
        (iy[:, :, None] >= 0)
        & (iy[:, :, None] < H)
        & (ix[:, None, :] >= 0)
        & (ix[:, None, :] < W)
    )
    iyc = np.clip(iy, 0, H - 1)
    ixc = np.clip(ix, 0, W - 1)
    np.add.at(
        frame,
        (
            np.broadcast_to(iyc[:, :, None], stamps.shape),
            np.broadcast_to(ixc[:, None, :], stamps.shape),
        ),
        np.where(ok, stamps, 0.0),
    )
    return frame


def particle_pair(
    shape: Tuple[int, int] = (512, 512),
    displacement: Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]
    | Tuple[float, float] = (3.3, -2.1),
    density: float = 0.02,
    diameter: float = 2.5,
    noise: float = 2.0,
    background: float = 8.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generate a uint8 frame pair with known displacement.

    ``displacement`` is either a constant ``(u, v)`` in pixels (u = +x/cols,
    v = +y/rows, image coordinates) or a callable ``(x, y) -> (u, v)`` over
    particle positions for non-uniform flow (e.g. shear).
    """
    H, W = shape
    rng = np.random.default_rng(seed)
    n = int(density * H * W)
    margin = 16
    xs = rng.uniform(-margin, W + margin, n)
    ys = rng.uniform(-margin, H + margin, n)
    inten = rng.uniform(100, 220, n)

    if callable(displacement):
        u, v = displacement(xs, ys)
    else:
        u = np.full(n, displacement[0])
        v = np.full(n, displacement[1])

    fa = render_particles((H, W), xs, ys, inten, diameter)
    fb = render_particles((H, W), xs + u, ys + v, inten, diameter)

    def finish(f):
        f = f + background + rng.normal(0, noise, f.shape)
        return np.clip(f, 0, 255).astype(np.uint8)

    return finish(fa), finish(fb)


def shear_flow(u0: float = 1.0, du_dy: float = 0.004):
    """Linear shear: u(y) = u0 + du_dy * y, v = 0."""

    def disp(xs, ys):
        return u0 + du_dy * ys, np.zeros_like(xs)

    return disp
