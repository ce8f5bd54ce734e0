"""Predictor upsampling operators between pass grids (numpy/scipy).

Copy of ``torchpiv_tpu/ops/spline.py``.  A tensor-product interpolating
spline on fixed grids is a linear operator, ``fine = A_y @ coarse @ A_x.T``;
the per-axis operators are extracted once by evaluating scipy's own
``RectBivariateSpline`` on one-hot data, so the engine's upsample is two
small matrix products.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


def _as_key(a: np.ndarray) -> tuple:
    return tuple(np.asarray(a, dtype=np.float64).ravel().tolist())


@lru_cache(maxsize=64)
def _spline_matrix_cached(coarse_key, fine_key, k) -> np.ndarray:
    from scipy.interpolate import RectBivariateSpline

    coarse = np.asarray(coarse_key, dtype=np.float64)
    fine = np.asarray(fine_key, dtype=np.float64)
    n = len(coarse)
    kk = min(k, n - 1)
    # column i of A is the spline of the i-th one-hot data vector on the
    # fine grid (an interpolating spline reproduces constants along the
    # dummy second axis exactly)
    A = np.empty((len(fine), n), dtype=np.float64)
    dummy = coarse
    for i in range(n):
        U = np.zeros((n, n))
        U[i, :] = 1.0
        A[:, i] = RectBivariateSpline(coarse, dummy, U, ky=kk, kx=kk)(
            fine, dummy[:1]
        )[:, 0]
    return A


def spline_matrix(coarse: np.ndarray, fine: np.ndarray, k: int = 3) -> np.ndarray:
    """Exact linear operator of scipy's interpolating spline on fixed grids
    (cubic by default; degree drops to ``len(coarse)-1`` on tiny grids)."""
    return _spline_matrix_cached(_as_key(coarse), _as_key(fine), k)


def upsample_matrices(
    y_coarse: np.ndarray,
    x_coarse: np.ndarray,
    y_fine: np.ndarray,
    x_fine: np.ndarray,
    k: int = 3,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis operators ``(A_y, A_x)`` with ``fine = A_y @ U @ A_x.T``."""
    return spline_matrix(y_coarse, y_fine, k), spline_matrix(x_coarse, x_fine, k)
