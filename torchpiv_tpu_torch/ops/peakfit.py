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

``warp_fit_steps`` replays the CUDA kernel's own steps on the CPU (which
lane holds which sample, the shuffle reductions, the band of rows that the
second-peak exclusion is tested on), for the tests.
"""
from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-7
WARP_FIT_MAX = 128  # csrc/peakfit.cu: a warp a map up to this side


def _offset_excluded(dd: torch.Tensor, k: int, w: int) -> torch.Tensor:
    """Flat offset ``dd`` from the first peak of a map with ``k`` columns
    lies in its ``(2w+1)**2`` neighbourhood iff it decomposes as ``i +
    k*j`` with ``|i|, |j| <= w``, ``j`` the offset over ``k`` rounded half
    to even in float32, as ``rintf`` (for a power-of-two ``k`` the division
    equals the CUDA kernels' multiply by ``1/k``)."""
    j = torch.round(dd.to(torch.float32) / k).to(dd.dtype)
    return (j.abs() <= w) & ((dd - k * j).abs() <= w)


def _end_flags(m: torch.Tensor, k: int, kd: int, w: int):
    """Whether the neighbourhood of peak ``m`` runs off the start or the
    end of the ``kd`` samples: the reference's clamp then excludes flat
    index 0 or ``kd - 1``."""
    return (m - (w + k * w)) < 0, (m + (w + k * w)) > kd - 1


def exclusion_mask(m: torch.Tensor, k: int, kd: int, w: int) -> torch.Tensor:
    """The reference's second-peak exclusion as a bool ``[n, kd]`` mask over
    every sample of the maps whose first peaks are at flat indices ``m``
    (``[n]``), in int32 offsets."""
    m = m.to(torch.int32)
    pos = torch.arange(kd, dtype=torch.int32, device=m.device)
    excl = _offset_excluded(pos[None, :] - m[:, None], k, w)
    lo, hi = _end_flags(m, k, kd, w)
    excl[:, 0] |= lo
    excl[:, kd - 1] |= hi
    return excl


def excluded(p: torch.Tensor, m: torch.Tensor, k: int, kd: int,
             w: int) -> torch.Tensor:
    """``exclusion_mask`` at flat positions ``p`` (``[n, ...]``) only."""
    m = m.reshape(m.shape[0], *([1] * (p.dim() - 1)))
    lo, hi = _end_flags(m, k, kd, w)
    return _offset_excluded(p - m, k, w) | ((p == 0) & lo) | ((p == kd - 1) & hi)


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
    # EPS as a Python scalar (rounded to the maps' dtype by the ops): a
    # tensor made on a CUDA device would wait for the device here
    shift = EPS - flat.amin(dim=-1) if min_subtract else EPS
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

    masked = flat.masked_fill(exclusion_mask(m, k, kd, validation_window), -torch.inf)
    c2 = torch.clamp(masked.amax(dim=-1) + shift, min=0.0)
    invalid = (cm / c2) < val_ratio
    degenerate = (left >= kd - 1) & (right <= 0) & (top >= kd - 1) & (bot <= 0)
    invalid = invalid | degenerate
    if not return_second:
        return u, v, invalid
    u2, v2, _, _ = fit_at(torch.argmax(masked, dim=-1))
    return u, v, invalid, (u2, v2)


def warp_fit_plan(d: int) -> Tuple[int, int]:
    """``(CH, MAXC)`` of ``csrc/peakfit.cu``'s warp instance for ``d x d``
    maps: ``CH`` slots a chunk, at most ``MAXC`` chunks (1: the map stays in
    registers); up to ``d = 32`` the least power of two with ``32 * CH >=
    d * d``."""
    if not 1 <= d <= WARP_FIT_MAX:
        raise ValueError(f"no warp instance for {d} px maps (1..{WARP_FIT_MAX})")
    if d > 32:
        return (8, 16) if d <= 64 else (16, 32)
    ch = 1
    while 32 * ch < d * d:
        ch *= 2
    return ch, 1


def _xor_reduce(vals, combine):
    """``vals`` (tensors ``[..., 32]``, one value a lane) by the kernel's
    shuffle-xor butterfly, offsets 16 down to 1: every lane ends with the
    result of ``combine(mine, partner's)``."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        vals = combine(vals, [v[..., lane ^ o] for v in vals])
    return vals


def _first_max(mine, other):
    """The larger value, the lesser flat index on a tie (NaN never wins)."""
    (v, i), (ov, oi) = mine, other
    take = (ov > v) | ((ov == v) & (oi < i))
    return [torch.where(take, ov, v), torch.where(take, oi, i)]


def warp_fit_steps(
    corr: torch.Tensor,
    validate: bool = True,
    val_ratio: float = 1.2,
    validation_window: int = 3,
    min_subtract: bool = False,
):
    """``correlation_to_displacement`` (gauss3, ``[N, d, d]`` maps up to
    ``WARP_FIT_MAX``) by the steps of ``csrc/peakfit.cu``'s warp kernel,
    with tensor ops: lane ``l`` holds samples ``l + 32 s`` (slots ``s``,
    ``-inf`` past the map); the first walk over the slots in order keeps a
    NaN-propagating minimum, the first strict maximum and each chunk's
    maximum; shuffle-xor reductions (the lesser index on a tie); a map with
    a NaN takes its first NaN as the peak and fits to 0; the five samples
    of the fit, one a lane, each ``(x - min) + EPS``; the second walk skips
    chunks (``MAXC > 1``) and slots that miss the rows within ``vw + 1`` of
    the peak's, taking their maxima whole, and tests exclusion on the rest.
    Raises if an excluded sample lies outside that band.  A model of the
    kernel's index arithmetic for the CPU tests: no path of the package
    calls it."""
    n, d, k = corr.shape
    if d != k:
        raise ValueError(f"square maps only, not {tuple(corr.shape)}")
    ch, maxc = warp_fit_plan(d)
    kd = d * k
    vw = validation_window
    nc = -(-kd // (32 * ch))
    flat = corr.reshape(n, kd).to(torch.float32)
    lane = torch.arange(32)
    pos = lane[None, :] + 32 * torch.arange(nc * ch)[:, None]  # [slot, lane]
    inside = pos < kd
    neg_inf = torch.tensor(-torch.inf)
    val = torch.where(inside, flat[:, pos.clamp(max=kd - 1)], neg_inf)  # [n, slot, lane]

    mn = torch.full((n, 32), torch.inf)
    best = torch.full((n, 32), -torch.inf)
    best_slot = torch.full((n, 32), -1)
    cmax = torch.full((n, nc, 32), -torch.inf)
    for s in range(nc * ch):
        c = val[:, s]
        mn = torch.where(inside[s], torch.minimum(mn, c), mn)  # min.NaN
        up = c > best
        best = torch.where(up, c, best)
        best_slot = torch.where(up, s, best_slot)
        cmax[:, s // ch] = torch.fmax(cmax[:, s // ch], c)
    m = torch.where(best_slot < 0, kd, lane + 32 * best_slot)
    (mn,) = _xor_reduce([mn], lambda a, b: [torch.minimum(a[0], b[0])])
    best, m = _xor_reduce([best, m], _first_max)
    mn, m = mn[:, 0], m[:, 0]
    nan = torch.isnan(mn)
    # a map with a NaN: the lanes' strided walks for the first NaN, then min
    first_nan = torch.where(torch.isnan(flat), torch.arange(kd), kd).amin(dim=1)
    m = torch.where(m >= kd, 0, m)

    def neighbours(mi):
        return (torch.where(mi + 1 >= kd - 1, mi, mi + 1),
                torch.where(mi - 1 <= 0, mi, mi - 1),
                torch.where(mi + k >= kd - 1, mi, mi + k),
                torch.where(mi - k <= 0, mi, mi - k))

    def degenerate(mi):
        left, right, top, bot = neighbours(mi)
        return (left >= kd - 1) & (right <= 0) & (top >= kd - 1) & (bot <= 0)

    def shifted(c):
        return (c - mn[:, None]) + EPS if min_subtract else c + EPS

    at = torch.stack([m, *neighbours(m)], dim=1)  # lanes 0..4
    x = shifted(torch.gather(flat, 1, at))
    lx = torch.log(x)
    lcm = lx[:, 0]
    # lane 0: gauss3 from lanes 1-2 (u), lane 1: from lanes 3-4 (v)
    du = (lx[:, 2] - lx[:, 1]) / (2.0 * (lx[:, 1] + lx[:, 2]) - 4.0 * lcm)
    dv = (lx[:, 4] - lx[:, 3]) / (2.0 * (lx[:, 3] + lx[:, 4]) - 4.0 * lcm)
    u = torch.nan_to_num(torch.remainder(m, k).to(torch.float32) + du - (k // 2))
    v = torch.nan_to_num(torch.div(m, d, rounding_mode="floor").to(torch.float32)
                         + dv - (d // 2))
    zero = torch.zeros(())
    u = torch.where(nan, zero, u)
    v = torch.where(nan, zero, v)
    if not validate:
        return u, v, None

    row = torch.div(m, k, rounding_mode="floor")
    band_lo = (row - vw - 1).clamp(min=0) * k
    band_hi = (row + vw + 2).clamp(max=d) * k - 1
    every = torch.arange(kd).expand(n, kd)
    outside = (every < band_lo[:, None]) | (every > band_hi[:, None])
    if bool((excluded(every, m, k, kd, vw) & outside)[~nan].any()):
        raise RuntimeError("warp_fit_steps: an excluded sample lies outside the band")

    c2 = torch.full((n, 32), -torch.inf)
    chunk = 32 * ch
    for j in range(nc):
        read = torch.ones(n, dtype=torch.bool)
        if maxc > 1:  # a chunk that misses the band gives its maximum whole
            read = (band_hi >= j * chunk) & (band_lo < (j + 1) * chunk)
            c2 = torch.where(read[:, None], c2, torch.fmax(c2, cmax[:, j]))
        for s in range(j * ch, (j + 1) * ch):
            misses = (32 * s + 31 < band_lo) | (32 * s > band_hi)
            keep = misses[:, None] | ~excluded(pos[s].expand(n, 32), m, k, kd, vw)
            c2 = torch.where(read[:, None] & keep, torch.fmax(c2, val[:, s]), c2)
    (c2,) = _xor_reduce([c2], lambda a, b: [torch.fmax(a[0], b[0])])
    c2 = torch.clamp(shifted(c2[:, :1])[:, 0], min=0.0)  # max.NaN: NaN kept
    invalid = ((x[:, 0] / c2) < val_ratio) | degenerate(m)
    invalid = torch.where(nan, degenerate(first_nan), invalid)
    return u, v, invalid
