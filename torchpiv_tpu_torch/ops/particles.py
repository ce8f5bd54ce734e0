"""Particle detection for PTV (counterpart of
``torchpiv_tpu/ops/particles.py``).

Particle images are located to sub-pixel accuracy so that scattered
per-particle vectors can be tracked (``models/ptv.py``): a separable
Gaussian matched filter (``ops.filters.gaussian_blur``), non-maximum
suppression by max pooling, and ``torch.topk`` over a fixed particle
capacity with a validity mask instead of a data-dependent count.  A batch
axis takes the place of the JAX package's ``vmap``.

The matched filter (Crocker & Grier, J. Colloid Interface Sci. 179 (1996))
makes saturated particles detectable: a clipped plateau becomes a dome with
one maximum.  Sub-pixel refinement is the 3-point log-Gaussian fit of the
correlation peak fit, on the filtered response.

``max_pool2d`` pads with -inf, as the JAX package's ``reduce_window`` max
does, and the minimum is ``-max_pool2d(-f)``; both are exact, so the peak
test ``f == pooled`` is too.  The order among tied responses and the
indices of the padding entries are not defined alike in ``torch.topk`` and
``lax.top_k``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .filters import gaussian_blur


def _delta(lo, hi, c):
    """3-point log-Gaussian offset; a flat stencil stays on the integer
    peak."""
    den = 2.0 * (lo + hi - 2.0 * c)
    return torch.where(den.abs() > 1e-12, (lo - hi) / den, torch.zeros_like(den))


def detect_particles(
    frame: torch.Tensor,
    max_particles: int = 4096,
    min_distance: int = 3,
    threshold: Optional[torch.Tensor] = None,
    n_sigma: float = 4.0,
    smooth_sigma: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Locate bright particle images in ``[H, W]`` or ``[B, H, W]`` frames.

    Returns ``(xs, ys, response, valid)``, each ``[max_particles]`` (or
    ``[B, max_particles]``), brightest response first; ``valid`` marks real
    detections.  ``min_distance``: the non-maximum-suppression half-width.
    ``threshold``: an absolute floor on the filtered response (a scalar or
    one a frame); by default ``mean + n_sigma * std`` of each frame's
    response (population std).  ``smooth_sigma``: the matched filter's
    width in px.  Positions are sub-pixel, the stencil clamped to the frame
    interior at the borders.
    """
    single = frame.dim() == 2
    f = gaussian_blur(frame.float(), smooth_sigma, truncate=3.0)
    f = f.reshape(-1, *f.shape[-2:])
    B, H, W = f.shape
    if threshold is None:
        thr = (f.mean(dim=(1, 2)) + n_sigma * f.std(dim=(1, 2), correction=0))
    else:
        thr = torch.as_tensor(threshold, dtype=torch.float32,
                              device=f.device).reshape(-1).expand(B)
    win = 2 * min_distance + 1
    pooled = F.max_pool2d(f[:, None], win, 1, min_distance)[:, 0]
    # a flat window (blank frame, dead sensor region) ties the maximum
    # everywhere: require genuine local contrast
    pooled_min = -F.max_pool2d(-f[:, None], win, 1, min_distance)[:, 0]
    is_peak = (f == pooled) & (f >= thr[:, None, None]) & (pooled > pooled_min)

    score = torch.where(is_peak, f, -torch.inf).reshape(B, -1)
    vals, idx = torch.topk(score, max_particles, dim=1)
    valid = torch.isfinite(vals)
    ys = torch.div(idx, W, rounding_mode="floor")
    xs = idx % W
    yc = ys.clamp(1, H - 2)
    xc = xs.clamp(1, W - 2)
    flat = f.reshape(B, -1)

    def log_at(dy, dx):
        at = torch.gather(flat, 1, (yc + dy) * W + (xc + dx))
        return torch.log(torch.clamp(at, min=1e-6))

    lc, ll, lr, lu, ld = (log_at(*o) for o in ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)))
    dx = torch.clamp(_delta(ll, lr, lc), -1.0, 1.0)
    dy = torch.clamp(_delta(lu, ld, lc), -1.0, 1.0)
    out = (xc + dx, yc + dy, torch.gather(flat, 1, yc * W + xc), valid)
    return tuple(t[0] for t in out) if single else out
