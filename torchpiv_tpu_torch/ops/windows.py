"""Interrogation-window extraction (counterpart of
``torchpiv_tpu/ops/windows.py``), and the static per-window pixel indices
(numpy, copies of the JAX package's)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .geometry import window_origins


def window_index_1d(
    image_size: Tuple[int, int], wind_size: int, overlap: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-axis pixel indices of every window: ``iy`` ``[n_rows, w]``
    and ``ix`` ``[n_cols, w]``; ``iy[r, p]`` is the frame row of pixel-row
    ``p`` of window-row ``r``.  (Copy of ``torchpiv_tpu/ops/windows.py:21-32``.)"""
    row0, col0 = window_origins(image_size, wind_size, overlap)
    w = np.arange(wind_size, dtype=np.int32)
    return row0[:, None] + w[None, :], col0[:, None] + w[None, :]


def flat_window_grid(
    image_size: Tuple[int, int], wind_size: int, overlap: int
) -> np.ndarray:
    """Flattened-frame pixel index of each window pixel, ``[N, w, w]`` int32
    (the reference's ``idx`` grid, PIVbackend.py:684-687).  (Copy of
    ``torchpiv_tpu/ops/windows.py:100-114``.)"""
    H, W = int(image_size[-2]), int(image_size[-1])
    iy, ix = window_index_1d((H, W), wind_size, overlap)
    n_rows, n_cols = iy.shape[0], ix.shape[0]
    flat = (
        iy[:, None, :, None].astype(np.int64) * W
        + ix[None, :, None, :].astype(np.int64)
    )
    return flat.reshape(n_rows * n_cols, wind_size, wind_size).astype(np.int32)


def extract_windows(frame: torch.Tensor, wind_size: int, overlap: int) -> torch.Tensor:
    """All interrogation windows of ``frame`` (``[..., H, W]``) as
    ``[..., n_rows * n_cols, w, w]`` in row-major window order.

    Two ``unfold`` calls give the strided view ``[..., n_rows, n_cols, w, w]``
    (the reference's ``as_strided`` window array); the reshape copies it.
    """
    step = wind_size - overlap
    win = frame.unfold(-2, wind_size, step).unfold(-2, wind_size, step)
    return win.reshape(*frame.shape[:-2], -1, wind_size, wind_size)
