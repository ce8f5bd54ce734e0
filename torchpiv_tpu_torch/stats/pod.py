"""Snapshot POD (proper orthogonal decomposition) of PIV field sequences;
a copy of ``torchpiv_tpu/stats/pod.py``.

Standard turbulence post-analysis downstream of instantaneous PIV fields
(Sirovich, Q. Appl. Math. 45 (1987): the method of snapshots — eigenmodes
of the [N, N] snapshot correlation matrix instead of the [2RC, 2RC]
spatial one, the right formulation for PIV where N_snapshots << N_points).
The reference accumulates only first/second moments (workers.py:85-119);
POD gives the energy-ranked coherent structures those moments average out.

Host-side numpy; an [N, 2RC] SVD at PIV scales (thousands of snapshots,
~16k vectors) is seconds of LAPACK work, not a device-path op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class PODResult:
    """Energy-ranked POD of a velocity-fluctuation sequence.

    - ``energies[m]``: eigenvalue of mode m (mean kinetic energy captured,
      in the fields' units squared); ``energy_fraction`` sums to 1.
    - ``modes_u/modes_v [M, R, C]``: orthonormal spatial modes.
    - ``coeffs [N, M]``: temporal coefficients; snapshot i reconstructs as
      ``mean + sum_m coeffs[i, m] * mode[m]``.
    - ``mean_u/mean_v [R, C]``: the subtracted ensemble mean.
    """

    energies: np.ndarray
    energy_fraction: np.ndarray
    modes_u: np.ndarray
    modes_v: np.ndarray
    coeffs: np.ndarray
    mean_u: np.ndarray
    mean_v: np.ndarray

    def reconstruct(self, i: int, n_modes: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Low-order reconstruction of snapshot ``i`` from ``n_modes``."""
        m = self.modes_u.shape[0] if n_modes is None else n_modes
        a = self.coeffs[i, :m]
        u = self.mean_u + np.tensordot(a, self.modes_u[:m], axes=1)
        v = self.mean_v + np.tensordot(a, self.modes_v[:m], axes=1)
        return u, v


def compute_pod(
    u_stack: np.ndarray,
    v_stack: np.ndarray,
    n_modes: Optional[int] = None,
    mask: Optional[np.ndarray] = None,
) -> PODResult:
    """Snapshot POD of ``[N, R, C]`` u/v sequences.

    Fluctuations about the ensemble mean are decomposed; ``mask`` (``[R,C]``
    or ``[N,R,C]``, True = invalid) and NaNs are replaced by the ensemble
    mean at that point, i.e. they contribute zero fluctuation rather than
    poisoning the correlation matrix.
    """
    u = np.asarray(u_stack, dtype=np.float64)
    v = np.asarray(v_stack, dtype=np.float64)
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(f"expected matching [N,R,C] stacks, got "
                         f"{u.shape} / {v.shape}")
    n, r, c = u.shape
    bad = ~np.isfinite(u) | ~np.isfinite(v)
    if mask is not None:
        bad |= np.broadcast_to(np.asarray(mask, dtype=bool), u.shape)
    # mean over the VALID snapshots at each point, computed as sum/count
    # (no nanmean: a point invalid in EVERY snapshot would emit a
    # mean-of-empty-slice RuntimeWarning; here its count is 0 and its
    # mean is defined as 0, i.e. zero fluctuation)
    cnt = (~bad).sum(axis=0)
    denom = np.maximum(cnt, 1)
    mean_u = np.where(bad, 0.0, u).sum(axis=0) / denom
    mean_v = np.where(bad, 0.0, v).sum(axis=0) / denom
    fu = np.where(bad, 0.0, u - mean_u[None]).reshape(n, -1)
    fv = np.where(bad, 0.0, v - mean_v[None]).reshape(n, -1)
    x = np.concatenate([fu, fv], axis=1)  # [N, 2RC]

    # economy SVD of the snapshot matrix: X = A S Phi^T with Phi the
    # spatial modes; eigenvalues of the snapshot correlation are S^2/N
    a_t, s, phi_t = np.linalg.svd(x, full_matrices=False)
    m_max = int((s > s[0] * 1e-12).sum()) if s.size and s[0] > 0 else 0
    m = m_max if n_modes is None else min(n_modes, m_max)
    energies = (s**2) / n
    total = float(energies.sum())
    coeffs = a_t[:, :m] * s[:m]
    phi = phi_t[:m]
    return PODResult(
        energies=energies[:m],
        energy_fraction=(energies / total if total > 0
                         else np.zeros_like(energies))[:m],
        modes_u=phi[:, : r * c].reshape(m, r, c),
        modes_v=phi[:, r * c:].reshape(m, r, c),
        coeffs=coeffs,
        mean_u=mean_u,
        mean_v=mean_v,
    )
