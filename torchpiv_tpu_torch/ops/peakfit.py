"""Sub-pixel peak location and peak-ratio validation (counterpart of
``torchpiv_tpu/ops/peakfit.py``): the gauss3 fit (two 3-point log-Gaussian
axis fits), the gauss2d fit (9-point log-paraboloid least squares, falling
back to gauss3 where the paraboloid is degenerate or the offset leaves the
pixel cell) and, with ``return_second``, the same fit at the second
correlation peak, the candidate of secondary-peak substitution.

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

This chain of torch ops (gauss3, no second peak) is also the plain version
of the fused CUDA peak-fit kernel (``kernels/peakfit.py``).  One difference is inherited from the JAX
package: with ``min_subtract`` the XLA fit, and so this function, adds
``EPS - min`` to a sample in one step, which loses ``EPS`` once
``|min| >= 2``, while the fused kernels compute ``(x - min) + EPS``.  The two
agree unless a sample that the fit reads lies within about 2 of the map's
minimum (a blank window).
"""
from __future__ import annotations

import torch

EPS = 1e-7


def correlation_to_displacement(
    corr: torch.Tensor,
    validate: bool = True,
    val_ratio: float = 1.2,
    validation_window: int = 3,
    min_subtract: bool = False,
    fit: str = "gauss3",
    return_second: bool = False,
):
    """``[N, d, k]`` correlation maps (square) -> ``(u, v, invalid)``.

    ``u, v`` are flat ``[N]`` signed displacements in pixels (centre =
    fftshift origin); ``invalid`` is a ``[N]`` bool mask of windows whose
    first/second peak ratio is below ``val_ratio`` (None when ``validate``
    is False).  With ``min_subtract`` the maps are raw and the per-window
    minimum is folded into the sampled values.  ``fit`` is ``"gauss3"`` or
    ``"gauss2d"``.  With ``return_second`` (needs ``validate``) the result
    is ``(u, v, invalid, (u2, v2))``, the second pair fitted at the second
    peak with the same estimator.
    """
    if return_second and not validate:
        raise ValueError("return_second requires validate=True (the second "
                         "peak is located via the validation exclusion set)")
    if fit not in ("gauss3", "gauss2d"):
        raise ValueError(f"unknown fit {fit!r}")
    n, d, k = corr.shape
    kd = k * d
    fdt = corr.dtype

    flat = corr.reshape(n, kd)
    eps = torch.tensor(EPS, dtype=fdt, device=corr.device)
    shift = eps - flat.amin(dim=-1) if min_subtract else eps
    m = torch.argmax(flat, dim=-1)

    def take(idx):
        return torch.gather(flat, 1, idx[:, None])[:, 0] + shift

    def fit_at(mi):
        """Sub-pixel fit around the flat index ``mi`` -> ``(u, v, cm,
        edges)``: the peak value and the edge-replaced neighbour indices
        serve the validation of the first peak."""
        left = torch.where(mi + 1 >= kd - 1, mi, mi + 1)
        right = torch.where(mi - 1 <= 0, mi, mi - 1)
        top = torch.where(mi + k >= kd - 1, mi, mi + k)
        bot = torch.where(mi - k <= 0, mi, mi - k)

        cm, cl, cr, ct, cb = (take(i) for i in (mi, left, right, top, bot))
        lcm, lcl, lcr, lct, lcb = (torch.log(c) for c in (cm, cl, cr, ct, cb))
        du = (lcr - lcl) / (2.0 * (lcl + lcr) - 4.0 * lcm)
        dv = (lcb - lct) / (2.0 * (lcb + lct) - 4.0 * lcm)

        if fit == "gauss2d":
            # log I = a + b x + c y + d x^2 + e y^2 + f xy over the 3x3
            # neighbourhood, closed form on the {-1, 0, 1}^2 grid; +x is
            # "left" (mi + 1), +y is "top" (mi + k); the diagonal neighbours
            # take the same clamp-to-peak rule as the axis ones
            def clampi(idx):
                return torch.where((idx <= 0) | (idx >= kd - 1), mi, idx)

            ctl = torch.log(take(clampi(mi - k - 1)))
            ctr = torch.log(take(clampi(mi - k + 1)))
            cbl = torch.log(take(clampi(mi + k - 1)))
            cbr = torch.log(take(clampi(mi + k + 1)))
            S = lcm + lcl + lcr + lct + lcb + ctl + ctr + cbl + cbr
            Sx = lcl - lcr + cbr - cbl + ctr - ctl
            Sy = lct - lcb + cbl + cbr - ctl - ctr
            Sxy = cbr - cbl - ctr + ctl
            Sxx = lcl + lcr + ctl + ctr + cbl + cbr
            Syy = lct + lcb + ctl + ctr + cbl + cbr
            b = Sx / 6.0
            c_ = Sy / 6.0
            f_ = Sxy / 4.0
            d2 = (Sxx - 2.0 / 3.0 * S) / 2.0
            e2 = (Syy - 2.0 / 3.0 * S) / 2.0
            det = 4.0 * d2 * e2 - f_ * f_
            du2 = (f_ * c_ - 2.0 * e2 * b) / det
            dv2 = (f_ * b - 2.0 * d2 * c_) / det
            # the 3-point fit where the paraboloid is degenerate or the
            # offset leaves the pixel cell
            bad = (~torch.isfinite(du2)) | (~torch.isfinite(dv2)) \
                | (du2.abs() > 1.0) | (dv2.abs() > 1.0) | (det <= 0)
            du = torch.where(bad, du, du2)
            dv = torch.where(bad, dv, dv2)

        row = torch.div(mi, d, rounding_mode="floor").to(fdt)
        col = (mi % k).to(fdt)
        u = torch.nan_to_num(col + du - (k // 2))
        v = torch.nan_to_num(row + dv - (d // 2))
        return u, v, cm, (left, right, top, bot)

    u, v, cm, (left, right, top, bot) = fit_at(m)
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
    invalid = invalid | degenerate
    if not return_second:
        return u, v, invalid
    u2, v2, _, _ = fit_at(torch.argmax(masked, dim=-1))
    return u, v, invalid, (u2, v2)
