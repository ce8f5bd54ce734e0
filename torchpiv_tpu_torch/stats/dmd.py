"""Dynamic mode decomposition of time-resolved PIV sequences;
a copy of ``torchpiv_tpu/stats/dmd.py``.

Complements snapshot POD (stats/pod.py): POD ranks structures by energy,
DMD extracts structures with a SINGLE frequency and growth rate each —
the standard tool for identifying shedding/instability dynamics in
time-resolved PIV (Schmid, J. Fluid Mech. 656 (2010); exact-DMD form of
Tu et al., J. Comput. Dyn. 1 (2014)).  The reference has no time-domain
analysis at all (its statistics are ensemble moments, workers.py:85-119).

Host-side numpy: one economy SVD of the [2RC, N-1] snapshot matrix plus
an [r, r] eigendecomposition — LAPACK work, not a device-path op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class DMDResult:
    """Exact DMD of a velocity sequence sampled every ``dt`` seconds.

    Mode m evolves as ``mode[m] * amplitude[m] * exp((growth[m] +
    2*pi*i*frequency[m]) * t)``; real flows yield conjugate pairs (only
    one of each pair is physical — filter ``frequencies >= 0``).

    - ``eigenvalues [M]``: discrete-time Ritz values (|lam| < 1 decays).
    - ``frequencies [M]`` Hz, ``growth_rates [M]`` 1/s (continuous time).
    - ``modes_u/modes_v [M, R, C]``: complex spatial modes.
    - ``amplitudes [M]``: complex scaling fitted to the first snapshot.
    """

    eigenvalues: np.ndarray
    frequencies: np.ndarray
    growth_rates: np.ndarray
    modes_u: np.ndarray
    modes_v: np.ndarray
    amplitudes: np.ndarray
    mean_u: np.ndarray
    mean_v: np.ndarray
    dt: float

    def reconstruct(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Snapshot ``i`` rebuilt from all retained modes (real part)."""
        w = self.amplitudes * self.eigenvalues**i
        u = self.mean_u + np.tensordot(w, self.modes_u, axes=1).real
        v = self.mean_v + np.tensordot(w, self.modes_v, axes=1).real
        return u, v


def compute_dmd(
    u_stack: np.ndarray,
    v_stack: np.ndarray,
    dt: float = 1.0,
    rank: Optional[int] = None,
    subtract_mean: bool = True,
    mask: Optional[np.ndarray] = None,
) -> DMDResult:
    """Exact DMD of ``[N, R, C]`` u/v sequences (N >= 3 snapshots).

    ``rank`` truncates the SVD (default: all modes above the numerical
    noise floor) — truncation is the standard guard against fitting
    measurement noise.  ``mask``/NaNs are replaced by the temporal mean
    at that point (zero fluctuation), like POD.  With
    ``subtract_mean=True`` (default) the decomposition acts on
    fluctuations — right for statistically-stationary data, where the
    temporal mean approximates the true steady component.  For TRANSIENT
    data (growing/decaying modes) use ``subtract_mean=False``: the
    temporal mean of a transient lies inside the mode subspace, and
    subtracting it makes the shifted dynamics affine, biasing the Ritz
    values (Chen, Tu & Rowley, J. Nonlinear Sci. 22 (2012)).
    """
    u = np.asarray(u_stack, dtype=np.float64)
    v = np.asarray(v_stack, dtype=np.float64)
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(f"expected matching [N,R,C] stacks, got "
                         f"{u.shape} / {v.shape}")
    n, r_, c_ = u.shape
    if n < 3:
        raise ValueError(f"need >= 3 snapshots for DMD, got {n}")
    bad = ~np.isfinite(u) | ~np.isfinite(v)
    if mask is not None:
        bad |= np.broadcast_to(np.asarray(mask, dtype=bool), u.shape)
    # mean over the VALID snapshots at each point, computed as sum/count
    # (no nanmean: a point invalid in EVERY snapshot would emit a
    # mean-of-empty-slice RuntimeWarning; here its count is 0 and its
    # mean is defined as 0 — same convention as stats/pod.py)
    cnt = (~bad).sum(axis=0)
    denom = np.maximum(cnt, 1)
    mu = np.where(bad, 0.0, u).sum(axis=0) / denom
    mv = np.where(bad, 0.0, v).sum(axis=0) / denom
    if not subtract_mean:
        mu = np.zeros_like(mu)
        mv = np.zeros_like(mv)
    fu = np.where(bad, 0.0, u - mu[None]).reshape(n, -1)
    fv = np.where(bad, 0.0, v - mv[None]).reshape(n, -1)
    snaps = np.concatenate([fu, fv], axis=1).T  # [2RC, N]

    x, xp = snaps[:, :-1], snaps[:, 1:]
    uu, s, vh = np.linalg.svd(x, full_matrices=False)
    keep = int((s > s[0] * 1e-10).sum()) if s.size and s[0] > 0 else 0
    if keep == 0:
        raise ValueError("snapshot matrix is numerically zero")
    r = keep if rank is None else min(rank, keep)
    uu, s, vh = uu[:, :r], s[:r], vh[:r]

    atilde = uu.conj().T @ xp @ vh.conj().T / s
    lam, w = np.linalg.eig(atilde)
    # exact DMD modes: Phi = X' V S^-1 W
    phi = xp @ vh.conj().T / s @ w  # [2RC, r]
    # amplitudes from the first snapshot (least squares)
    b, *_ = np.linalg.lstsq(phi, snaps[:, 0], rcond=None)

    with np.errstate(divide="ignore", invalid="ignore"):
        omega = np.log(lam) / dt  # continuous-time exponents
    order = np.argsort(-np.abs(b) * np.abs(lam))
    lam, omega, b = lam[order], omega[order], b[order]
    phi = phi[:, order].T  # [r, 2RC]
    return DMDResult(
        eigenvalues=lam,
        frequencies=omega.imag / (2 * np.pi),
        growth_rates=omega.real,
        modes_u=phi[:, : r_ * c_].reshape(r, r_, c_),
        modes_v=phi[:, r_ * c_:].reshape(r, r_, c_),
        amplitudes=b,
        mean_u=mu,
        mean_v=mv,
        dt=dt,
    )
