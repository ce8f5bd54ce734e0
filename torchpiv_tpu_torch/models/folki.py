"""FOLKI-style dense Lucas-Kanade PIV (Champagnat et al., Exp. Fluids 50
(2011)): iterative windowed least squares instead of FFT correlation
(counterpart of ``torchpiv_tpu/models/folki.py``).

The estimator minimises, at every pixel, the windowed SSD between frame A
and the warped frame B; each Gauss-Newton update solves one 2x2 system per
pixel whose entries are box sums of gradient products, and a mean pyramid
handles displacements beyond the linearisation range.  The solver is
elementwise math, separable box sums and bilinear gathers on the frame's
device; Python loops take the place of ``lax.fori_loop``.

How the JAX operations map:

* ``_box``, the zero-padded ``(2r+1)^2`` "SAME" sum, is two 1-D
  ``avg_pool2d`` passes (``count_include_pad``) times ``(2r+1)^2``: no
  float32 cumulative sums, whose rounding over 2048 columns would swamp a
  17-px window sum; the two divisions and the product add a few ulp;
* ``_warp`` is ``map_coordinates(order=1, mode="nearest")`` in its own
  arithmetic: floor, two weights a tap, each tap's index clamped to the
  frame, the four products summed in its order (``grid_sample``'s
  normalised coordinates would lose about 1e-4 px at 2048 px);
* ``jnp.gradient`` is the engine's ``_gradient`` with unit spacing;
* ``jax.image.resize(..., "bilinear")``, which only upsamples here, is
  ``F.interpolate(mode="bilinear", align_corners=False)``: half-pixel
  centres, the edge sample's weight renormalised to 1 in both;
* ``grid_output``'s strided VALID ``reduce_window`` is ``avg_pool2d`` with
  the window as kernel and the grid step as stride.

Conventions match the engine: u = +x (cols), v = +y (rows), px units.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.filters import gaussian_blur
from ..ops.geometry import get_coordinates
from ..utils.device import resolve_device
from .multipass import MultipassPIV, _gradient


def _box(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Zero-padded ``(2r+1)^2`` window sums of ``[..., H, W]``."""
    w = 2 * radius + 1
    y = x.reshape(-1, 1, *x.shape[-2:])
    y = F.avg_pool2d(y, (1, w), 1, (0, radius), count_include_pad=True)
    y = F.avg_pool2d(y, (w, 1), 1, (radius, 0), count_include_pad=True)
    return y.reshape(x.shape) * float(w * w)


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """PIV particle images are only ~2-3 px wide, so they alias away under
    plain decimation and their gradients under-sample; smoothing is what
    makes LK converge on them."""
    return gaussian_blur(x, sigma, truncate=2.5)


def _grads(f: torch.Tensor):
    """``jnp.gradient(f)`` of ``[H, W]``: ``(d/dy, d/dx)``."""
    return _gradient(f, 1.0, -2), _gradient(f, 1.0, -1)


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``img`` ``[H, W]`` sampled at ``(y + v, x + u)``, bilinear, the
    indices clamped to the frame."""
    H, W = img.shape
    dev = img.device
    cy = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + v
    cx = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + u
    taps = []
    for c, size in ((cy, H), (cx, W)):
        lower = torch.floor(c)
        upper_w = c - lower
        i = lower.to(torch.int64)
        taps.append(((i.clamp(0, size - 1), 1 - upper_w),
                     ((i + 1).clamp(0, size - 1), upper_w)))
    flat = img.reshape(-1)
    out = None
    for iy, wy in taps[0]:
        for ix, wx in taps[1]:
            term = (wy * wx) * flat[iy * W + ix]
            out = term if out is None else out + term
    return out


def _level_flow(a, b, u, v, radius: int, iters: int):
    """Gauss-Newton iterations at one pyramid level.

    The linearisation gradient is the AVERAGE of frame A's and the warped
    frame B's (the symmetric form: the fixed-template gradient alone
    oscillates after ~2 iterations); the normal equations are those of the
    TOTAL flow (FOLKI's fixed-point-stable form), and each sweep moves at
    most 1 px.
    """
    dya, dxa = _grads(a)
    for _ in range(iters):
        bw = _warp(b, u, v)
        dyb, dxb = _grads(bw)
        gx = 0.5 * (dxa + dxb)
        gy = 0.5 * (dya + dyb)
        d = a - bw
        sums = _box(torch.stack([
            gx * gx, gx * gy, gy * gy,
            gx * d + gx * gx * u + gx * gy * v,
            gy * d + gx * gy * u + gy * gy * v]), radius)
        a11 = sums[0] + 1e-4
        a12 = sums[1]
        a22 = sums[2] + 1e-4
        r1, r2 = sums[3], sums[4]
        det = a11 * a22 - a12 * a12
        un = (a22 * r1 - a12 * r2) / det
        vn = (a11 * r2 - a12 * r1) / det
        u, v = (u + torch.clamp(un - u, -1.0, 1.0),
                v + torch.clamp(vn - v, -1.0, 1.0))
    return u, v


def _upsample(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear")`` of ``[h, w]`` for
    ``shape`` at least as large."""
    return F.interpolate(x[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False)[0, 0]


@torch.no_grad()
def folki_flow(frame_a: torch.Tensor, frame_b: torch.Tensor, radius: int = 8,
               iters: int = 8, levels: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-pixel flow ``(u, v)`` ``[H, W]`` from A to B (px), on the
    frames' device.

    ``radius``: window half-size of the local least squares (about a
    quarter of the equivalent correlation window); ``levels``: mean-pyramid
    depth, level L handling displacements up to ~2^L px.  Frame dimensions
    must be divisible by ``2**(levels-1)``.
    """
    a = frame_a.float() / 255.0
    b = frame_b.float() / 255.0
    H, W = a.shape
    f = 2 ** (levels - 1)
    if H % f or W % f:
        raise ValueError(f"frame {tuple(a.shape)} not divisible by {f} (levels={levels})")

    # solve-time smoothing at every level + anti-aliased decimation
    pyr = [(_blur(a, 1.0), _blur(b, 1.0))]
    for _ in range(levels - 1):
        a = _blur(a, 1.0)
        b = _blur(b, 1.0)
        a = a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2).mean(dim=(1, 3))
        b = b.reshape(b.shape[0] // 2, 2, b.shape[1] // 2, 2).mean(dim=(1, 3))
        pyr.append((_blur(a, 1.0), _blur(b, 1.0)))

    al, bl = pyr[-1]
    u = torch.zeros_like(al)
    v = torch.zeros_like(al)
    for lev in range(levels - 1, -1, -1):
        al, bl = pyr[lev]
        if u.shape != al.shape:
            u = 2.0 * _upsample(u, al.shape)
            v = 2.0 * _upsample(v, al.shape)
        # coarser levels see shrunken windows of the same physical size
        u, v = _level_flow(al, bl, u, v, max(2, radius >> lev), iters)
    return u, v


class FolkiPIV(nn.Module):
    """Engine-shaped wrapper: dense flow fitted onto the PIV grid, with a
    residual-based validity mask.

    >>> fp = FolkiPIV((1024, 1024), wind_size=32, overlap=16)
    >>> u, v, invalid = fp(frame_a, frame_b)     # [R, C] numpy

    With ``piv_config`` (hybrid predictor-corrector) the correlation engine
    supplies the initial field, dense LK polishes it, and windows LK cannot
    trust keep the correlation value.  The engine's final pass must have
    this grid's nodes.
    """

    def __init__(self, frame_shape: Tuple[int, int], wind_size: int = 32,
                 overlap: int = 16, radius: Optional[int] = None,
                 iters: int = 8, levels: int = 3,
                 residual_threshold: float = 0.12, min_contrast: float = 0.01,
                 piv_config=None, device="auto"):
        super().__init__()
        self.frame_shape = tuple(frame_shape)
        gx, gy = get_coordinates(self.frame_shape, wind_size, overlap)
        self.engine = None
        if piv_config is not None:
            if tuple(piv_config.frame_shape) != self.frame_shape:
                raise ValueError("piv_config.frame_shape "
                                 f"{piv_config.frame_shape} != {self.frame_shape}")
            ew, eo = piv_config.pass_schedule()[-1]
            egx, egy = get_coordinates(self.frame_shape, ew, eo)
            if not (np.array_equal(egx, gx) and np.array_equal(egy, gy)):
                raise ValueError(
                    "hybrid mode needs IDENTICAL grids (node positions, "
                    f"not just counts): engine final pass ({ew}, {eo}) vs "
                    f"dense output ({wind_size}, {overlap}) — pick "
                    "wind_size/overlap equal to the engine's final pass")
            self.engine = MultipassPIV(piv_config, device=device)
        self.wind_size = int(wind_size)
        self.radius = int(radius if radius is not None else wind_size // 4)
        self.iters = int(iters)
        self.levels = int(levels)
        self.residual_threshold = float(residual_threshold)
        self.min_contrast = float(min_contrast)
        self.coordinates = (gx, gy)
        # node k's window starts at off + k*step, fully inside the frame
        self._step = wind_size - overlap
        self._off_y = int(round(float(gy[0, 0]))) - wind_size // 2
        self._off_x = int(round(float(gx[0, 0]))) - wind_size // 2
        self._grid_shape = gx.shape
        H, W = self.frame_shape
        w = self.wind_size
        # conditioned coordinates of the window fits, and the nodes' pixels
        self.register_buffer("xs", (torch.arange(W, dtype=torch.float32) - W / 2.0) / w)
        self.register_buffer("ys", (torch.arange(H, dtype=torch.float32) - H / 2.0) / w)
        self.register_buffer("rows", torch.from_numpy(np.rint(gy[:, 0]).astype(np.int64)))
        self.register_buffer("cols", torch.from_numpy(np.rint(gx[0, :]).astype(np.int64)))
        self.to(self.engine.device if self.engine is not None
                else resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def _avg(self, x: torch.Tensor) -> torch.Tensor:
        """One complete ``w x w`` window a grid node, averaged (strided
        VALID windows; edge nodes average their full window)."""
        R, C = self._grid_shape
        w, step = self.wind_size, self._step
        y = x[..., self._off_y:, self._off_x:]
        s = F.avg_pool2d(y.reshape(-1, 1, *y.shape[-2:]), w, step)
        return s[:, 0, :R, :C].reshape(*x.shape[:-2], R, C)

    def grid_output(self, a, b, u, v):
        """Dense flow -> PIV grid: a texture-weighted LINEAR fit per window
        evaluated at the node (a plain weighted mean is biased on sheared
        flows; uniform averaging lets inter-particle drift dominate at
        sparse seeding), and the residual/contrast validity."""
        af = a.float() / 255.0
        bf = b.float() / 255.0
        res = (_warp(bf, u, v) - af).abs()
        gy_, gx_ = _grads(_blur(af, 1.0))
        tex = gx_ * gx_ + gy_ * gy_
        xs = self.xs[None, :]
        ys = self.ys[:, None]
        txs, tys = tex * xs, tex * ys
        avg = self._avg(torch.stack([
            tex, txs, tys, txs * xs, txs * ys, tys * ys,
            tex * u, txs * u, tys * u, tex * v, txs * v, tys * v,
            res, af * af, af]))
        s0 = avg[0] + 1e-12
        sx_g, sy_g, sxx_g, sxy_g, syy_g = avg[1:6]
        xc = self.xs[self.cols][None, :]
        yc = self.ys[self.rows][:, None]
        # recentre the moments on each node (float32 conditioning)
        sx = sx_g - xc * s0
        sy = sy_g - yc * s0
        sxx = sxx_g - 2 * xc * sx_g + xc * xc * s0
        sxy = sxy_g - xc * sy_g - yc * sx_g + xc * yc * s0
        syy = syy_g - 2 * yc * sy_g + yc * yc * s0
        c11 = sxx * syy - sxy * sxy
        c12 = sy * sxy - sx * syy
        c13 = sx * sxy - sy * sxx
        det = s0 * c11 + sx * c12 + sy * c13
        ok = det.abs() > 1e-6 * torch.clamp(s0, min=1e-12) ** 3

        def fit_at_node(s1, s1x_g, s1y_g):
            s1x = s1x_g - xc * s1
            s1y = s1y_g - yc * s1
            val = (c11 * s1 + c12 * s1x + c13 * s1y) / det
            # degenerate texture: the weighted mean
            return torch.where(ok, val, s1 / s0)

        uw = fit_at_node(*avg[6:9])
        vw = fit_at_node(*avg[9:12])
        # untrustworthy: a high residual for the contrast, or no texture at
        # all (the residual is deceptively zero on a blank region)
        contrast = torch.sqrt(torch.clamp(avg[13] - avg[14] ** 2, min=1e-8))
        bad = (avg[12] / contrast > self.residual_threshold) | (contrast < self.min_contrast)
        return uw, vw, bad

    @torch.no_grad()
    def forward(self, frame_a, frame_b):
        """One frame pair (numpy or tensors) -> ``(u, v, invalid)`` numpy
        ``[R, C]``."""
        a = torch.as_tensor(frame_a).to(self.device)
        b = torch.as_tensor(frame_b).to(self.device)
        if self.engine is None:
            u, v = folki_flow(a, b, radius=self.radius, iters=self.iters,
                              levels=self.levels)
            return tuple(t.cpu().numpy() for t in self.grid_output(a, b, u, v))
        u0, v0, inval = self.engine(a, b)
        u0 = u0.cpu().numpy().astype(np.float64)
        v0 = v0.cpu().numpy().astype(np.float64)
        bad0 = (np.zeros(u0.shape, bool) if inval is None
                else inval.cpu().numpy().astype(bool))
        if bad0.any():
            fill_u = np.median(u0[~bad0]) if (~bad0).any() else 0.0
            fill_v = np.median(v0[~bad0]) if (~bad0).any() else 0.0
            u0 = np.where(bad0, fill_u, u0)
            v0 = np.where(bad0, fill_v, v0)
        u0d, v0d = (_upsample(torch.from_numpy(x.astype(np.float32)).to(self.device),
                              self.frame_shape) for x in (u0, v0))
        af = _blur(a.float() / 255.0, 1.0)
        bf = _blur(b.float() / 255.0, 1.0)
        u, v = _level_flow(af, bf, u0d, v0d, self.radius, self.iters)
        u, v, bad = (t.cpu().numpy() for t in self.grid_output(a, b, u, v))
        # LK refines the correlation anchor: keep it only where it stayed
        # near the anchor and passed its own gates
        keep = ~bad & (np.abs(u - u0) < 0.5) & (np.abs(v - v0) < 0.5)
        return np.where(keep, u, u0), np.where(keep, v, v0), ~keep & bad0
