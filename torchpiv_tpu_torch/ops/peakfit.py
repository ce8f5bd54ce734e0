"""Sub-pixel peak location and peak-ratio validation (counterpart of
``torchpiv_tpu/ops/peakfit.py``, gauss3 fit).

It keeps the reference's flat-index edge behaviour:

* neighbour indices are taken on the flattened map, so at map edges the
  left/right neighbours wrap across rows, and indices past the ends are
  replaced by the peak index itself;
* the second-peak search excludes a ``(2w+1)**2`` neighbourhood of the first
  peak by flat offset, with the reference's clamp collapsing out-of-range
  offsets onto flat index 0 or ``kd - 1``;
* NaN/Inf fit results are flushed with ``nan_to_num``.

``torch.argmax`` returns the first maximal index, as ``jnp.argmax`` does, and
``torch.round`` rounds half to even, as ``jnp.round`` does.

This chain of torch ops is also the plain version of the fused CUDA peak-fit
kernel (``kernels/peakfit.py``).  One difference is inherited from the JAX
package: with ``min_subtract`` the XLA fit, and so this function, adds
``EPS - min`` to a sample in one step, which loses ``EPS`` once
``|min| >= 2``, while the fused kernels compute ``(x - min) + EPS``.  The two
agree unless a sample that the fit reads lies within about 2 of the map's
minimum (a blank window).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-7


def correlation_to_displacement(
    corr: torch.Tensor,
    validate: bool = True,
    val_ratio: float = 1.2,
    validation_window: int = 3,
    min_subtract: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``[N, d, k]`` correlation maps (square) -> ``(u, v, invalid)``.

    ``u, v`` are flat ``[N]`` signed displacements in pixels (centre =
    fftshift origin); ``invalid`` is a ``[N]`` bool mask of windows whose
    first/second peak ratio is below ``val_ratio`` (None when ``validate``
    is False).  With ``min_subtract`` the maps are raw and the per-window
    minimum is folded into the sampled values.
    """
    n, d, k = corr.shape
    kd = k * d
    fdt = corr.dtype

    flat = corr.reshape(n, kd)
    eps = torch.tensor(EPS, dtype=fdt, device=corr.device)
    shift = eps - flat.amin(dim=-1) if min_subtract else eps
    m = torch.argmax(flat, dim=-1)

    def take(idx):
        return torch.gather(flat, 1, idx[:, None])[:, 0] + shift

    left = torch.where(m + 1 >= kd - 1, m, m + 1)
    right = torch.where(m - 1 <= 0, m, m - 1)
    top = torch.where(m + k >= kd - 1, m, m + k)
    bot = torch.where(m - k <= 0, m, m - k)

    cm, cl, cr, ct, cb = (take(i) for i in (m, left, right, top, bot))
    lcm, lcl, lcr, lct, lcb = (torch.log(c) for c in (cm, cl, cr, ct, cb))
    du = (lcr - lcl) / (2.0 * (lcl + lcr) - 4.0 * lcm)
    dv = (lcb - lct) / (2.0 * (lcb + lct) - 4.0 * lcm)

    row = torch.div(m, d, rounding_mode="floor").to(fdt)
    col = (m % k).to(fdt)
    u = torch.nan_to_num(col + du - (k // 2))
    v = torch.nan_to_num(row + dv - (d // 2))

    if not validate:
        return u, v, None

    w = validation_window
    # flat position p is excluded iff off = p - m decomposes as i + k*j with
    # |i|, |j| <= w: j = round(off / k) in range and |off - k*j| <= w
    pos = torch.arange(kd, dtype=torch.int32, device=corr.device)
    off = pos[None, :] - m.to(torch.int32)[:, None]
    j = torch.round(off.to(fdt) / k).to(torch.int32)
    excl = (j.abs() <= w) & ((off - k * j).abs() <= w)
    # offsets that fall off the ends clamp onto flat index 0 / kd-1
    excl[:, 0] |= (m - (w + k * w)) < 0
    excl[:, kd - 1] |= (m + (w + k * w)) > kd - 1
    masked = flat.masked_fill(excl, -torch.inf)
    c2 = torch.clamp(masked.amax(dim=-1) + shift, min=0.0)
    invalid = (cm / c2) < val_ratio
    degenerate = (left >= kd - 1) & (right <= 0) & (top >= kd - 1) & (bot <= 0)
    return u, v, invalid | degenerate
