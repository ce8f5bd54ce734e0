"""Interrogation-grid geometry (numpy, set-up time only).

Copy of ``torchpiv_tpu/ops/geometry.py``: windows of size ``wind_size``
tile the frame with stride ``wind_size - overlap``; the reported
window-center coordinates carry the reference's integer centring offset,
the window origins do not.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def get_field_shape(
    image_size: Tuple[int, int], wind_size: int, overlap: int
) -> Tuple[int, int]:
    """Number of interrogation-window rows/cols for a frame:
    ``(image - wind) // (wind - overlap) + 1`` per axis."""
    rows = (int(image_size[-2]) - wind_size) // (wind_size - overlap) + 1
    cols = (int(image_size[-1]) - wind_size) // (wind_size - overlap) + 1
    return rows, cols


def get_coordinates(
    image_size: Tuple[int, int], wind_size: int, overlap: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel coordinates of window centers as ``(x, y)`` meshgrids of shape
    ``(n_rows, n_cols)``, shifted so both frame margins are equal."""
    n_rows, n_cols = get_field_shape(image_size, wind_size, overlap)
    step = wind_size - overlap

    x = np.arange(n_cols, dtype=np.int32) * step + wind_size / 2.0
    y = np.arange(n_rows, dtype=np.int32) * step + wind_size / 2.0

    x += (image_size[-1] - 1 - ((n_cols - 1) * step + (wind_size - 1))) // 2
    y += (image_size[-2] - 1 - ((n_rows - 1) * step + (wind_size - 1))) // 2

    return np.meshgrid(x, y)


def window_origins(
    image_size: Tuple[int, int], wind_size: int, overlap: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-left pixel (row0, col0) of every window row/col (multiples of the
    stride from pixel (0, 0); the origins are not centred)."""
    n_rows, n_cols = get_field_shape(image_size, wind_size, overlap)
    step = wind_size - overlap
    row0 = np.arange(n_rows, dtype=np.int32) * step
    col0 = np.arange(n_cols, dtype=np.int32) * step
    return row0, col0


def per_window_origins(
    image_size: Tuple[int, int], wind_size: int, overlap: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat ``[N]`` top-left (row, col) of every window, row-major.
    (Copy of ``per_window_origins`` in ``torchpiv_tpu/ops/shifts.py``.)"""
    row0, col0 = window_origins(image_size, wind_size, overlap)
    r = np.repeat(row0, len(col0))
    c = np.tile(col0, len(row0))
    return r.astype(np.int32), c.astype(np.int32)
