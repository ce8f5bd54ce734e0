"""Ensemble turbulence statistics over a sequence of velocity fields
(a copy of ``torchpiv_tpu/stats/ensemble.py``, which is numpy only).

Numpy port of the reference worker's post-processing (the reference's
``torchPIV/workers.py:85-119``): ensemble means, Reynolds stresses, velocity
gradients, vorticity and shear, emitted as the same 13-column table (same
column names/order, same mid-field spacing convention and the same
``np.gradient(avg, dx, dy)`` axis-naming quirk, preserved verbatim so saved
statistics files match the reference's byte-for-column).
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


class EnsembleAccumulator:
    """Streaming accumulator: feed per-pair (u, v), finalize to the table.

    Uses running sums rather than stacking all fields (the reference stacks
    every field in RAM, workers.py:61-62 — fine for hundreds of pairs, not
    for hundreds of thousands), in float64 like the reference.
    """

    def __init__(self):
        self.n = 0
        self._mu = self._mv = None
        self._muu = self._mvv = self._muv = None  # centered-moment sums

    def add(self, u: np.ndarray, v: np.ndarray) -> None:
        # Welford update: numerically matches the reference's two-pass
        # centered moments to ~1e-15 without stacking all fields in RAM.
        u = np.asarray(u, dtype=np.float64)
        v = np.asarray(v, dtype=np.float64)
        if self.n == 0:
            self._mu = np.zeros_like(u)
            self._mv = np.zeros_like(v)
            self._muu = np.zeros_like(u)
            self._mvv = np.zeros_like(v)
            self._muv = np.zeros_like(u)
        self.n += 1
        du = u - self._mu
        dv = v - self._mv
        self._mu += du / self.n
        self._mv += dv / self.n
        self._muu += du * (u - self._mu)
        self._mvv += dv * (v - self._mv)
        self._muv += du * (v - self._mv)

    def merge(self, other: "EnsembleAccumulator") -> "EnsembleAccumulator":
        """Fold another accumulator into this one (in place) — the Chan
        et al. parallel combination of Welford moments, exact up to fp
        rounding.  Enables sharded campaigns: each process/host accumulates
        its own pair block and the states merge into the same statistics a
        single sequential pass would produce (see parallel.distributed).
        """
        if other.n == 0:
            return self
        if self.n == 0:
            self.n = other.n
            for f in ("_mu", "_mv", "_muu", "_mvv", "_muv"):
                setattr(self, f, np.copy(getattr(other, f)))
            return self
        na, nb = self.n, other.n
        n = na + nb
        du = other._mu - self._mu
        dv = other._mv - self._mv
        self._muu += other._muu + du * du * (na * nb / n)
        self._mvv += other._mvv + dv * dv * (na * nb / n)
        self._muv += other._muv + du * dv * (na * nb / n)
        self._mu += du * (nb / n)
        self._mv += dv * (nb / n)
        self.n = n
        return self

    def finalize(self, x: np.ndarray, y: np.ndarray) -> Dict[str, np.ndarray]:
        if self.n == 0:
            raise ValueError("no fields accumulated")
        n = self.n
        return _assemble_table(
            x, y, self._mu, self._mv, self._muu / n, self._mvv / n, self._muv / n
        )


def compute_statistics(
    x: np.ndarray,
    y: np.ndarray,
    u_fields: Iterable[np.ndarray],
    v_fields: Iterable[np.ndarray],
) -> Dict[str, np.ndarray]:
    """Two-pass (stacked) statistics, numerically identical to the reference
    worker (mean then centered second moments, workers.py:88-95)."""
    u_inst = np.stack([np.asarray(u, dtype=np.float64) for u in u_fields])
    v_inst = np.stack([np.asarray(v, dtype=np.float64) for v in v_fields])
    avg_u = np.mean(u_inst, axis=0, dtype=np.float64)
    avg_v = np.mean(v_inst, axis=0, dtype=np.float64)
    uu = np.mean((u_inst - avg_u) ** 2, axis=0, dtype=np.float64)
    vv = np.mean((v_inst - avg_v) ** 2, axis=0, dtype=np.float64)
    uv = np.mean((u_inst - avg_u) * (v_inst - avg_v), axis=0, dtype=np.float64)
    return _assemble_table(x, y, avg_u, avg_v, uu, vv, uv)


def _assemble_table(x, y, avg_u, avg_v, uu, vv, uv) -> Dict[str, np.ndarray]:
    x = np.asarray(x)
    y = np.asarray(y)
    # Mid-field grid spacing in meters (x, y are in mm; workers.py:100-103).
    mid_i, mid_j = x.shape[-2] // 2, x.shape[-1] // 2
    dx = (x[mid_i, mid_j + 1] - x[mid_i, mid_j]) / 1000
    dy = (y[mid_i + 1, mid_j] - y[mid_i, mid_j]) / 1000
    # NOTE: spacing order (dx, dy) and the dUy/dUx unpack order reproduce the
    # reference verbatim (workers.py:104,110-116) — including its axis-name
    # swap — so downstream columns match numerically.
    dUy, dUx = np.gradient(avg_u, dx, dy, edge_order=2)
    dVy, dVx = np.gradient(avg_v, dx, dy, edge_order=2)
    return {
        "x[mm]": x,
        "y[mm]": y,
        "Vx[m/s]": avg_u,
        "Vy[m/s]": avg_v,
        "(vx-Vx)(vy-Vy)[m^2/s^2]": uv,
        "(vx-Vx)^2[m^2/s^2]": uu,
        "(vy-Vy)^2[m^2/s^2]": vv,
        "dVx/dx[1/s]": dUx,
        "dVx/dy[1/s]": dUy,
        "dVy/dx[1/s]": dVx,
        "dVy/dy[1/s]": dVy,
        "W[1/s]": dVx - dUy,
        "S[1/s]": dVx + dUy,
    }
