"""The lane-packed window layout of the JAX package's pass-fusion kernels
(counterpart of ``pack_windows`` in
``torchpiv_tpu/experimental/fused_pass.py``).

A window row's ``n_cols`` windows lie side by side along the last axis:
window ``c`` of row ``r`` occupies ``[r, :, c*w:(c+1)*w]`` of a
``[n_rows, w, Lp]`` tensor, with ``Lp = ceil(n_cols / G) * G * w`` and
``G = 128 // w``; the lanes past ``n_cols * w`` repeat the last window.  The
layout serves the TPU's 128-lane registers.  The port's kernels read the
standard ``[N, w, w]`` layout; these functions exist so that the port can
be held against the JAX functions that speak the packed one.
"""
from __future__ import annotations

import torch


def packed_width(n_cols: int, wind_size: int) -> int:
    """``Lp``, the last-axis length of the packed layout."""
    G = 128 // wind_size
    if G < 1:
        raise ValueError(f"the packed layout holds windows up to 128 px, not {wind_size}")
    return -(-n_cols // G) * G * wind_size


def pack_windows(windows: torch.Tensor, n_rows: int, n_cols: int,
                 wind_size: int) -> torch.Tensor:
    """``[..., N, w, w]`` windows (row-major, ``N = n_rows * n_cols``) ->
    the lane-packed ``[..., n_rows, w, Lp]`` layout."""
    w = wind_size
    Lp = packed_width(n_cols, w)
    lead = windows.shape[:-3]
    x = windows.reshape(*lead, n_rows, n_cols, w, w).transpose(-3, -2)
    x = x.reshape(*lead, n_rows, w, n_cols * w)
    if Lp != n_cols * w:
        pad = x[..., -w:].repeat(*([1] * (x.dim() - 1)), (Lp - n_cols * w) // w)
        x = torch.cat([x, pad], dim=-1)
    return x.contiguous()


def unpack_windows(packed: torch.Tensor, n_cols: int, wind_size: int) -> torch.Tensor:
    """The inverse of ``pack_windows``: ``[..., n_rows, w, Lp]`` ->
    ``[..., n_rows * n_cols, w, w]`` (the tail lanes are dropped)."""
    w = wind_size
    lead = packed.shape[:-3]
    n_rows = packed.shape[-3]
    x = packed[..., :n_cols * w].reshape(*lead, n_rows, w, n_cols, w)
    return x.transpose(-3, -2).reshape(*lead, n_rows * n_cols, w, w).contiguous()
