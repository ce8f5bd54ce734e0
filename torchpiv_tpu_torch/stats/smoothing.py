"""Robust penalized-least-squares smoothing of vector fields (smoothn);
a copy of ``torchpiv_tpu/stats/smoothing.py``.

Standard PIV post-processing (PIVlab's default smoother) that the reference
lacks entirely: D. Garcia, "Robust smoothing of gridded data in one and
higher dimensions with missing values", Comput. Stat. Data Anal. 54 (2010)
1167-1178.  Minimizes ``||W^(1/2)(y - z)||^2 + s ||Laplacian(z)||^2`` on a
uniform grid; the penalty operator diagonalizes in the DCT basis, so each
iteration is one forward/inverse DCT-II pair:

    z = IDCT( Gamma o DCT( W o (y - z) + z ) ),
    Gamma_k = 1 / (1 + s * Lambda_k^2),
    Lambda_k = sum_axes (2 - 2 cos(k_i pi / n_i))

with missing values carried as zero weight and the smoothing parameter
``s`` chosen by generalized cross-validation (GCV) when not given.  The
robust variant iteratively re-weights residuals with the bisquare function
so spurious vectors (the failure mode PIV validation exists for) do not
drag the fit.

Host-side numpy/scipy — runs on final [R, C] fields, not a hot path.
Implemented from the paper's equations (4), (6), (12)-(14); no reference
counterpart (reference post-processing is outlier NaN-infill only,
PIVbackend.py:284-344).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _lambda_grid(shape: Tuple[int, ...]) -> np.ndarray:
    """Eigenvalues of the (negative) Laplacian in the DCT-II basis."""
    lam = np.zeros(shape)
    for ax, n in enumerate(shape):
        k = np.arange(n).reshape([-1 if a == ax else 1
                                  for a in range(len(shape))])
        lam = lam + (2.0 - 2.0 * np.cos(np.pi * k / n))
    return lam


def _dctn(a: np.ndarray) -> np.ndarray:
    from scipy.fft import dctn

    return dctn(a, type=2, norm="ortho")


def _idctn(a: np.ndarray) -> np.ndarray:
    from scipy.fft import idctn

    return idctn(a, type=2, norm="ortho")


def smooth_field(
    y: np.ndarray,
    mask: Optional[np.ndarray] = None,
    s: Optional[float] = None,
    robust: bool = False,
    max_iter: int = 100,
    tol: float = 1e-3,
) -> Tuple[np.ndarray, float]:
    """Smooth one gridded scalar field; returns ``(z, s_used)``.

    ``mask`` marks samples to EXCLUDE (invalid vectors, same convention as
    the engine's ``inval``); NaNs in ``y`` are excluded automatically and
    come back filled with the smooth surface.  ``s=None`` selects the
    smoothing parameter by GCV; ``robust=True`` adds 3 bisquare
    re-weighting steps (Garcia 2010 sec. 3.2) so outliers that survived
    validation do not bias the surface.
    """
    if s is not None and s <= 0:
        raise ValueError("smoothing parameter s must be > 0 "
                         "(gamma = 1/(1 + s*lambda^2) requires it)")
    y = np.asarray(y, dtype=np.float64)
    w = np.isfinite(y).astype(np.float64)
    if mask is not None:
        w *= ~np.asarray(mask, dtype=bool)
    if w.sum() == 0:
        return y.copy(), 0.0
    yf = np.where(w > 0, np.nan_to_num(y), 0.0)
    any_missing = bool((w == 0).any())

    lam = _lambda_grid(y.shape)
    lam2 = lam * lam
    n = y.size
    n_valid = w.sum()

    # initial guess: valid-sample mean everywhere a sample is missing
    z = np.where(w > 0, yf, yf.sum() / max(n_valid, 1.0))

    def solve(z0, wgt, s_):
        gamma = 1.0 / (1.0 + s_ * lam2)
        z_ = z0
        for _ in range(max_iter if (any_missing or (wgt != 1).any()) else 1):
            z_new = _idctn(gamma * _dctn(wgt * (yf - z_) + z_))
            if np.max(np.abs(z_new - z_)) <= tol * max(
                    1e-12, np.max(np.abs(z_new))):
                z_ = z_new
                break
            z_ = z_new
        return z_

    def gcv(log10s, z0, wgt):
        s_ = 10.0 ** log10s
        z_ = solve(z0, wgt, s_)
        rss = float(np.sum(wgt * (yf - z_) ** 2))
        tr_h = float(np.sum(1.0 / (1.0 + s_ * lam2)))
        denom = (1.0 - tr_h / n) ** 2 * n_valid
        return rss / max(denom, 1e-300), z_

    def pick_s(z0, wgt):
        # coarse log-grid search then golden refinement — the GCV curve is
        # smooth and unimodal in log10(s) for this penalty
        grid = np.linspace(-6.0, 6.0, 25)
        scores = [gcv(g, z0, wgt)[0] for g in grid]
        i = int(np.argmin(scores))
        lo, hi = grid[max(0, i - 1)], grid[min(len(grid) - 1, i + 1)]
        from scipy.optimize import minimize_scalar

        r = minimize_scalar(lambda g: gcv(g, z0, wgt)[0],
                            bounds=(lo, hi), method="bounded",
                            options={"xatol": 1e-2})
        return 10.0 ** float(r.x)

    wgt = w.copy()
    s_used = s if s is not None else pick_s(z, wgt)
    z = solve(z, wgt, s_used)

    if robust:
        for _ in range(3):
            r = yf - z
            # studentized residuals (Garcia eq. 13-14): scale by MAD and
            # the average leverage of the smoother
            mad = np.median(np.abs(r[w > 0] - np.median(r[w > 0])))
            tr_h = float(np.sum(1.0 / (1.0 + s_used * lam2)))
            h = min(max(tr_h / n, 1e-6), 1.0 - 1e-6)
            ustud = r / max(1.4826 * mad, 1e-12) / np.sqrt(1.0 - h)
            bis = (1.0 - (ustud / 4.685) ** 2) ** 2
            wgt = w * np.where(np.abs(ustud) < 4.685, bis, 0.0)
            if s is None:
                s_used = pick_s(z, wgt)
            z = solve(z, wgt, s_used)

    return z, float(s_used)


def smooth_vector_field(
    u: np.ndarray,
    v: np.ndarray,
    mask: Optional[np.ndarray] = None,
    s: Optional[float] = None,
    robust: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Smooth both displacement components with one shared GCV-chosen
    parameter (the larger of the two components' choices, so neither is
    under-smoothed); returns ``(u_smooth, v_smooth)``.
    """
    if s is None:
        zu, su = smooth_field(u, mask=mask, robust=robust)
        zv, sv = smooth_field(v, mask=mask, robust=robust)
        s = max(su, sv)
        # only the component whose own GCV choice lost re-runs at the
        # shared parameter (halves the per-pair host cost vs smoothing
        # both components twice)
        if s > 0:
            if su < s:
                zu, _ = smooth_field(u, mask=mask, s=s, robust=robust)
            elif sv < s:
                zv, _ = smooth_field(v, mask=mask, s=s, robust=robust)
        return zu, zv
    zu, _ = smooth_field(u, mask=mask, s=s, robust=robust)
    zv, _ = smooth_field(v, mask=mask, s=s, robust=robust)
    return zu, zv
