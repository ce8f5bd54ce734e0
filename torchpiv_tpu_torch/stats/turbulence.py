"""Turbulence scales from planar PIV statistics;
a copy of ``torchpiv_tpu/stats/turbulence.py``.

The reference's statistics stop at Reynolds stresses and mean-field
gradients (workers.py:85-119); these are the standard next-step scalars
every turbulence study reports.  Planar 2D2C PIV measures 4 of the 12
velocity-gradient covariance terms, so the dissipation estimate uses the
isotropy-substitution form of Doron et al., J. Phys. Oceanogr. 31 (2001):

    eps = 4 nu [ <u_x'^2> + <v_y'^2> + <u_x' v_y'> + 3/4 <(u_y'+v_x')^2> ]

which is exact for isotropic turbulence and degrades gracefully (it is
zero for solid-body rotation, 3x the true value for pure mean shear —
fluctuation gradients, not mean gradients, should be fed to it).
Downstream scales follow the textbook definitions (Pope, "Turbulent
Flows", 2000): Kolmogorov length/time, Taylor microscale from
lambda^2 = 15 nu u_rms^2 / eps, Re_lambda, and the integral length scale
from the longitudinal autocorrelation of u along x.

Host-side numpy over instantaneous [N, R, C] stacks or single snapshots.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _fluct_gradients(u_stack, v_stack, dx, dy):
    u = np.asarray(u_stack, dtype=np.float64)
    v = np.asarray(v_stack, dtype=np.float64)
    if u.ndim == 2:
        u, v = u[None], v[None]
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(f"expected matching [N,R,C] stacks, got "
                         f"{np.shape(u_stack)} / {np.shape(v_stack)}")
    if u.shape[0] > 1:  # N=1: treat the snapshot as pure fluctuation
        u = u - np.nanmean(u, axis=0, keepdims=True)
        v = v - np.nanmean(v, axis=0, keepdims=True)
    u, v = np.nan_to_num(u), np.nan_to_num(v)
    dudy, dudx = np.gradient(u, dy, dx, axis=(1, 2), edge_order=2)
    dvdy, dvdx = np.gradient(v, dy, dx, axis=(1, 2), edge_order=2)
    return u, v, dudx, dudy, dvdx, dvdy


def dissipation_direct(
    u_stack: np.ndarray,
    v_stack: np.ndarray,
    nu: float,
    dx: float = 1.0,
    dy: float = 1.0,
) -> float:
    """Mean dissipation rate [m^2/s^3] via the Doron et al. (2001)
    isotropy-substitution estimate over FLUCTUATION gradients.

    ``u_stack``/``v_stack``: [N, R, C] instantaneous fields (N >= 2 so a
    temporal mean can be removed; a single snapshot is treated as pure
    fluctuation).  Underestimates when the interrogation-window spacing
    does not resolve the dissipative scales — report alongside
    ``kolmogorov_scales`` so readers can check dx vs eta.
    """
    _, _, dudx, dudy, dvdx, dvdy = _fluct_gradients(u_stack, v_stack, dx, dy)
    return float(4.0 * nu * (np.mean(dudx**2) + np.mean(dvdy**2)
                             + np.mean(dudx * dvdy)
                             + 0.75 * np.mean((dudy + dvdx)**2)))


def turbulent_kinetic_energy(uu, vv, ww: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """TKE map [m^2/s^2] from Reynolds normal stresses.  Planar PIV does
    not measure ``ww``; the default substitutes the isotropic-tendency
    estimate ``ww = (uu + vv)/2`` (exact for axisymmetric turbulence
    about the out-of-plane axis)."""
    uu = np.asarray(uu, dtype=np.float64)
    vv = np.asarray(vv, dtype=np.float64)
    ww = (uu + vv) / 2 if ww is None else np.asarray(ww, dtype=np.float64)
    return 0.5 * (uu + vv + ww)


def kolmogorov_scales(eps: float, nu: float) -> Dict[str, float]:
    """Kolmogorov length/time/velocity scales from dissipation."""
    if eps <= 0:
        return {"eta": np.inf, "tau_eta": np.inf, "u_eta": 0.0}
    return {
        "eta": float((nu**3 / eps) ** 0.25),
        "tau_eta": float((nu / eps) ** 0.5),
        "u_eta": float((nu * eps) ** 0.25),
    }


def taylor_microscale(u_rms: float, eps: float, nu: float) -> float:
    """lambda = sqrt(15 nu u_rms^2 / eps) (isotropic relation)."""
    if eps <= 0:
        return np.inf
    return float(np.sqrt(15.0 * nu * u_rms**2 / eps))


def taylor_reynolds(u_rms: float, eps: float, nu: float) -> float:
    """Re_lambda = u_rms * lambda / nu."""
    lam = taylor_microscale(u_rms, eps, nu)
    return float(u_rms * lam / nu) if np.isfinite(lam) else np.inf


def integral_length_scale(
    u_stack: np.ndarray,
    dx: float = 1.0,
    axis: int = -1,
) -> float:
    """Longitudinal integral length scale: integral of the spatial
    autocorrelation of the u-fluctuation along ``axis`` (columns = x by
    default), averaged over snapshots and rows, integrated up to the
    first zero crossing (the standard truncation for finite fields)."""
    u = np.asarray(u_stack, dtype=np.float64)
    if u.ndim == 2:
        u = u[None]
    if u.shape[0] > 1:
        u = u - np.nanmean(u, axis=0, keepdims=True)
    u = np.nan_to_num(np.moveaxis(u, axis, -1))
    n = u.shape[-1]
    if np.mean(u**2) <= 0:
        return 0.0
    corr = np.zeros(n)
    for lag in range(n):
        corr[lag] = (u[..., : n - lag] * u[..., lag:]).mean()
    rho = corr / corr[0]
    # integrate to the first zero crossing (or the full record)
    stop = int(np.argmax(rho <= 0)) if (rho <= 0).any() else n
    trap = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
    return float(trap(rho[:stop], dx=dx))


def turbulence_report(
    u_stack: np.ndarray,
    v_stack: np.ndarray,
    nu: float,
    dx: float = 1.0,
    dy: float = 1.0,
) -> Dict[str, float]:
    """One-call summary: TKE, dissipation, and the derived scales."""
    u = np.asarray(u_stack, dtype=np.float64)
    v = np.asarray(v_stack, dtype=np.float64)
    if u.ndim == 2:
        u, v = u[None], v[None]
    with np.errstate(invalid="ignore"):
        if u.shape[0] > 1:
            mu = np.nanmean(u, axis=0)
            mv = np.nanmean(v, axis=0)
        else:
            mu = mv = 0.0  # single snapshot: treat as pure fluctuation
        uu = np.nanmean((u - mu)**2, axis=0)
        vv = np.nanmean((v - mv)**2, axis=0)
    tke = float(np.nanmean(turbulent_kinetic_energy(uu, vv)))
    u_rms = float(np.sqrt(2.0 * tke / 3.0))  # isotropic 1-component rms
    eps = dissipation_direct(u, v, nu, dx, dy)
    scales = kolmogorov_scales(eps, nu)
    return {
        "tke": tke,
        "u_rms": u_rms,
        "dissipation": eps,
        "eta": scales["eta"],
        "tau_eta": scales["tau_eta"],
        "u_eta": scales["u_eta"],
        "taylor_microscale": taylor_microscale(u_rms, eps, nu),
        "re_lambda": taylor_reynolds(u_rms, eps, nu),
        "integral_length": integral_length_scale(u, dx),
        "resolution_dx_over_eta": (dx / scales["eta"]
                                   if np.isfinite(scales["eta"]) else 0.0),
    }
