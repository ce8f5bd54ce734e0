"""Interrogation-window extraction (counterpart of
``torchpiv_tpu/ops/windows.py``)."""
from __future__ import annotations

import torch


def extract_windows(frame: torch.Tensor, wind_size: int, overlap: int) -> torch.Tensor:
    """All interrogation windows of ``frame`` (``[..., H, W]``) as
    ``[..., n_rows * n_cols, w, w]`` in row-major window order.

    Two ``unfold`` calls give the strided view ``[..., n_rows, n_cols, w, w]``
    (the reference's ``as_strided`` window array); the reshape copies it.
    """
    step = wind_size - overlap
    win = frame.unfold(-2, wind_size, step).unfold(-2, wind_size, step)
    return win.reshape(*frame.shape[:-2], -1, wind_size, wind_size)
