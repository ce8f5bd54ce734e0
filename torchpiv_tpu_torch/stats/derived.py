"""Derived instantaneous-field quantities beyond the reference's table;
a copy of ``torchpiv_tpu/stats/derived.py``.

The reference's 13-column statistics stop at vorticity ``W = dVx - dUy``
and shear ``S = dVx + dUy`` of the ENSEMBLE mean (workers.py:100-118,
with its axis-name swap preserved in stats/ensemble.py).  These are the
remaining standard single-snapshot diagnostics (cf. PIVlab's derived
parameters):

* **divergence** — ``du/dx + dv/dy``; should vanish for planar
  incompressible flow, so its magnitude doubles as a data-quality map
  (out-of-plane motion / bad vectors).
* **swirling strength** (lambda_ci) — imaginary part of the 2-D velocity
  gradient tensor's complex eigenvalue (Zhou et al. 1999); unlike
  vorticity it is zero in pure shear, making it the standard vortex
  detector.
* **Okubo-Weiss parameter** — ``s_n^2 + s_s^2 - w^2`` (strain beats
  rotation > 0, rotation-dominated < 0).

Host-side numpy on final [R, C] fields; gradients use ``np.gradient``
with ``edge_order=2`` like the reference's statistics tail.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def velocity_gradients(u, v, dx: float = 1.0, dy: float = 1.0):
    """(du/dx, du/dy, dv/dx, dv/dy) on the grid (row axis = y)."""
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    dudy, dudx = np.gradient(u, dy, dx, edge_order=2)
    dvdy, dvdx = np.gradient(v, dy, dx, edge_order=2)
    return dudx, dudy, dvdx, dvdy


def divergence(u, v, dx: float = 1.0, dy: float = 1.0, *, grads=None
               ) -> np.ndarray:
    dudx, _, _, dvdy = grads or velocity_gradients(u, v, dx, dy)
    return dudx + dvdy


def vorticity(u, v, dx: float = 1.0, dy: float = 1.0, *, grads=None
              ) -> np.ndarray:
    """Out-of-plane vorticity ``dv/dx - du/dy`` (the physically-standard
    definition; the reference's table quantity carries its axis-name swap,
    documented in stats/ensemble.py)."""
    _, dudy, dvdx, _ = grads or velocity_gradients(u, v, dx, dy)
    return dvdx - dudy


def swirling_strength(u, v, dx: float = 1.0, dy: float = 1.0, *, grads=None
                      ) -> np.ndarray:
    """lambda_ci: imaginary part of the complex eigenvalue of the 2-D
    velocity-gradient tensor (0 where eigenvalues are real — pure
    shear/strain; > 0 inside vortices)."""
    dudx, dudy, dvdx, dvdy = grads or velocity_gradients(u, v, dx, dy)
    # eigenvalues of [[dudx, dudy], [dvdx, dvdy]]: lambda = tr/2 +- sqrt(D),
    # D = (tr/2)^2 - det; complex pair when D < 0, lambda_ci = sqrt(-D)
    half_tr = 0.5 * (dudx + dvdy)
    det = dudx * dvdy - dudy * dvdx
    disc = half_tr * half_tr - det
    return np.where(disc < 0, np.sqrt(np.maximum(-disc, 0.0)), 0.0)


def okubo_weiss(u, v, dx: float = 1.0, dy: float = 1.0, *, grads=None
                ) -> np.ndarray:
    dudx, dudy, dvdx, dvdy = grads or velocity_gradients(u, v, dx, dy)
    s_n = dudx - dvdy
    s_s = dvdx + dudy
    w = dvdx - dudy
    return s_n * s_n + s_s * s_s - w * w


def gradient_uncertainty(su, sv, dx: float = 1.0, dy: float = 1.0):
    """First-order propagation of per-vector uncertainties into the
    derived gradient maps.

    ``su``/``sv``: [R, C] standard uncertainties of u and v (e.g.
    ``stats.quality.uncertainty_map``), assumed independent between
    vectors.  Central differences ``(f[i+1]-f[i-1])/(2h)`` give
    ``var = (s[i+1]^2 + s[i-1]^2) / (2h)^2``; the returned maps are

    * ``sigma_vorticity`` — std of ``dv/dx - du/dy``
    * ``sigma_divergence`` — std of ``du/dx + dv/dy``

    (identical formulas — the two gradient terms are independent — so
    one computation serves both; edges use the variance of the same
    second-order one-sided stencil ``(-3f0+4f1-f2)/(2h)`` that
    ``np.gradient(edge_order=2)`` applies in the maps themselves).
    """
    su2 = np.asarray(su, dtype=np.float64) ** 2
    sv2 = np.asarray(sv, dtype=np.float64) ** 2
    if su2.shape != sv2.shape or su2.ndim != 2:
        raise ValueError(f"expected matching [R, C] maps, got "
                         f"{su2.shape} / {sv2.shape}")
    if min(su2.shape) < 3:
        raise ValueError("need at least a 3x3 grid for the edge stencils")

    def var_ddx(s2, h):
        out = np.empty_like(s2)
        out[:, 1:-1] = (s2[:, 2:] + s2[:, :-2]) / (2 * h) ** 2
        # edge_order=2 one-sided stencil (-3 f0 + 4 f1 - f2)/(2h)
        out[:, 0] = (9 * s2[:, 0] + 16 * s2[:, 1] + s2[:, 2]) / (2 * h) ** 2
        out[:, -1] = (9 * s2[:, -1] + 16 * s2[:, -2]
                      + s2[:, -3]) / (2 * h) ** 2
        return out

    def var_ddy(s2, h):
        return var_ddx(s2.T, h).T

    var_w = var_ddx(sv2, dx) + var_ddy(su2, dy)   # dv/dx - du/dy
    var_d = var_ddx(su2, dx) + var_ddy(sv2, dy)   # du/dx + dv/dy
    return {"sigma_vorticity": np.sqrt(var_w),
            "sigma_divergence": np.sqrt(var_d)}


def gamma_functions(u, v, dx: float = 1.0, dy: float = 1.0, radius: int = 2):
    """Graftieaux Gamma1 / Gamma2 vortex-identification functions
    (Graftieaux, Michard & Grosjean, Meas. Sci. Technol. 12 (2001)).

    Per grid point P, averaged over the ``(2*radius+1)^2`` neighborhood M:

        Gamma1 = < (PM x U_M).z / (|PM| |U_M|) >          (vortex CENTER:
                 |Gamma1| peaks ~1 at the core axis)
        Gamma2 = same with U_M replaced by U_M - <U>_window (convection
                 removed; |Gamma2| > 2/pi marks the vortex CORE region)

    Sign follows the vorticity convention (positive = counter-clockwise
    for y pointing up).  Dimensionless, robust to noise (it averages
    angles, not gradients) — the standard complement to lambda_ci.
    Returns ``(gamma1, gamma2)``.
    """
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    if u.shape != v.shape or u.ndim != 2:
        raise ValueError(f"expected matching [R, C] fields, got "
                         f"{u.shape} / {v.shape}")
    r_, c_ = u.shape
    n = int(radius)
    if n < 1:
        raise ValueError("radius must be >= 1")
    eps = 1e-30

    # local window means for Gamma2 (edge-clamped box filter)
    from scipy.ndimage import uniform_filter

    um = uniform_filter(u, size=2 * n + 1, mode="nearest")
    vm = uniform_filter(v, size=2 * n + 1, mode="nearest")

    g1 = np.zeros_like(u)
    g2 = np.zeros_like(u)
    count = 0
    for oy in range(-n, n + 1):
        for ox in range(-n, n + 1):
            if oy == 0 and ox == 0:
                continue
            count += 1
            # U at M = P + offset, clamped at borders (edge padding)
            ys = np.clip(np.arange(r_) + oy, 0, r_ - 1)
            xs = np.clip(np.arange(c_) + ox, 0, c_ - 1)
            uM = u[ys][:, xs]
            vM = v[ys][:, xs]
            px, py = ox * dx, oy * dy
            norm_p = np.hypot(px, py)
            cross = px * vM - py * uM
            g1 += cross / (norm_p * np.hypot(uM, vM) + eps)
            uF, vF = uM - um, vM - vm
            g2 += (px * vF - py * uF) / (norm_p * np.hypot(uF, vF) + eps)
    return g1 / count, g2 / count


def find_vortex_cores(u, v, dx: float = 1.0, dy: float = 1.0,
                      rel_threshold: float = 0.25):
    """Vortex-core locations from swirling-strength peaks.

    lambda_ci is THE locator: it is Galilean-invariant (a core advected
    by neighbouring vortices keeps its peak — Gamma1 dilutes there), it
    is exactly zero in pure shear, and it decays sharply away from the
    axis (Gamma2 plateaus at ~1 across a solid-body core AND sits above
    the 2/pi criterion far into an irrotational swirl's tail, so neither
    Gamma localises).  Connected regions of ``lambda_ci > rel_threshold *
    max`` become one core each at their lambda_ci-weighted centroid,
    split by rotation sense (sign of vorticity).  Returns ``(cols, rows,
    strength)`` in GRID-index units, strongest first; ``strength`` is the
    signed peak lambda_ci (positive = counter-clockwise for y up).
    """
    from scipy import ndimage

    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    bad = ~np.isfinite(u) | ~np.isfinite(v)
    if bad.any():
        # invalid vectors poison the gradient stencil; zero lambda_ci on
        # the contaminated cells so they can't become phantom cores
        u = np.nan_to_num(u)
        v = np.nan_to_num(v)
        bad = ndimage.binary_dilation(bad, iterations=2)  # edge_order=2
    g = velocity_gradients(u, v, dx, dy)
    lam = swirling_strength(u, v, grads=g)
    w = vorticity(u, v, grads=g)
    if bad.any():
        lam = np.where(bad, 0.0, lam)
    peak = float(lam.max())
    if peak <= 0:
        z = np.zeros(0)
        return z, z, z
    cand = []
    for sign in (1.0, -1.0):
        field = np.where(np.sign(w) == sign, lam, 0.0)
        lbl, n = ndimage.label(field > rel_threshold * peak)
        for k in range(1, n + 1):
            sel = lbl == k
            wts = field[sel]
            tot = wts.sum()
            rows_i, cols_i = np.nonzero(sel)
            cand.append((float((wts * cols_i).sum() / tot),
                         float((wts * rows_i).sum() / tot),
                         float(sign * wts.max())))
    cols, rows, s = map(np.asarray, zip(*cand))
    order = np.argsort(-np.abs(s))
    return cols[order], rows[order], s[order]


def track_vortex_cores(u_stack, v_stack, dx: float = 1.0, dy: float = 1.0,
                       rel_threshold: float = 0.25,
                       match_radius: float = 3.0, min_length: int = 3):
    """Follow vortex cores through a [T, R, C] snapshot sequence.

    Per-snapshot :func:`find_vortex_cores`, linked frame-to-frame with
    the PTV greedy unique matcher (``match_radius`` in grid cells).
    Returns a list of dicts ``{"frames", "cols", "rows", "strength"}``
    sorted longest-first — e.g. a shedding street yields one track per
    vortex, alternating in sign."""
    from ..models.ptv import greedy_link_steps

    u = np.asarray(u_stack, dtype=np.float64)
    v = np.asarray(v_stack, dtype=np.float64)
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError("expected matching [T, R, C] stacks")

    def steps():
        for t in range(u.shape[0]):
            cols, rows, s = find_vortex_cores(u[t], v[t], dx, dy,
                                              rel_threshold=rel_threshold)
            pos = np.column_stack([cols, rows])
            yield t, pos, pos, list(zip(cols, rows, s))

    # a vortex must keep its sense of rotation across frames
    keep_sense = lambda prev, new: prev[2] * new[2] > 0  # noqa: E731
    out = []
    for chain in greedy_link_steps(steps(), radius=match_radius,
                                   accept=keep_sense):
        if len(chain) < min_length:
            continue
        out.append({
            "frames": np.asarray([t for t, _, _ in chain]),
            "cols": np.asarray([pl[0] for _, _, pl in chain]),
            "rows": np.asarray([pl[1] for _, _, pl in chain]),
            "strength": np.asarray([pl[2] for _, _, pl in chain]),
        })
    out.sort(key=lambda d: -d["frames"].size)
    return out


def derived_fields(u, v, dx: float = 1.0, dy: float = 1.0
                   ) -> Dict[str, np.ndarray]:
    """All derived maps from one gradient pass: divergence, vorticity,
    swirling strength, Okubo-Weiss."""
    g = velocity_gradients(u, v, dx, dy)
    return {
        "divergence": divergence(u, v, grads=g),
        "vorticity": vorticity(u, v, grads=g),
        "swirling_strength": swirling_strength(u, v, grads=g),
        "okubo_weiss": okubo_weiss(u, v, grads=g),
    }
