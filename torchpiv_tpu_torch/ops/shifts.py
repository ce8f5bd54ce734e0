"""Per-window CWS/DWS window shift: the plain PyTorch version of the shift
kernel (``kernels/shift.py``).

It computes exactly what the TPU kernel ``_shift_kernel``
(``torchpiv_tpu/kernels/shift_pallas.py``) computes, which is what the TPU
main path runs:

* shifts clip to ``+-S`` with ``S = max_shift or max(w // 2, 1)``;
* ``dy, dx = floor(v)`` and ``fy, fx = v - floor(v)``, one pair per window;
* each window reads a ``(w+1)**2`` tile at its origin plus ``(dy, dx)``,
  clamped into the (padded) frame;
* the tile's four corner slices blend with per-window scalar weights, in the
  kernel's term order; a window whose shift is an integer in either axis
  takes the floor corner unchanged.

These differ from the XLA ``cws_shift``/``dws_shift`` of the JAX package
(per-pixel weights, no clamp).  With ``flat_wrap`` the frame is padded by
``flat_wrap_pad`` so edge windows reproduce the reference's flat-index
clamped addressing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .geometry import get_field_shape


def flat_wrap_pad(frame: torch.Tensor, P: int) -> torch.Tensor:
    """Pad ``[..., H, W]`` frames by ``P`` so that 2-D sampling of the result
    reproduces the reference's flat-index-clamped addressing of the original:
    out-of-row columns wrap into the adjacent row, and the overhangs before
    the first and after the last pixel clamp to those pixels."""
    H, W = frame.shape[-2:]
    lead = frame.shape[:-2]
    first = frame[..., :1, :1]
    last = frame[..., -1:, -1:]
    left = torch.roll(frame[..., W - P:], 1, dims=-2)
    left[..., 0, :] = first[..., 0, :]
    right = torch.roll(frame[..., :P], -1, dims=-2)
    right[..., -1, :] = last[..., 0, :]
    mid = torch.cat([left, frame, right], dim=-1)
    # virtual row -1 with columns >= W wraps forward into row 0's head;
    # deeper rows clamp entirely
    top = first.expand(*lead, P, W + 2 * P).clone()
    top[..., -1, W + P:] = frame[..., 0, :P]
    # virtual row H with columns < 0 wraps back into the last row's tail
    bot = last.expand(*lead, P, W + 2 * P).clone()
    bot[..., 0, :P] = frame[..., -1, W - P:]
    return torch.cat([top, mid, bot], dim=-2)


class ShiftOperands(NamedTuple):
    """What the shift kernel reads: the padded float32 frames ``[B, Hp, Wp]``,
    the per-window integer parts ``dy, dx`` (int32 ``[B, N]``) and fractional
    parts ``fy, fx`` (float32 ``[B, N]``), the window-origin offset into the
    padded frame, and the window grid."""

    frame: torch.Tensor
    dy: torch.Tensor
    dx: torch.Tensor
    fy: torch.Tensor
    fx: torch.Tensor
    off: int
    n_rows: int
    n_cols: int
    step: int


def shift_operands(
    frame: torch.Tensor,
    vel_x: torch.Tensor,
    vel_y: torch.Tensor,
    *,
    frame_shape: Tuple[int, int],
    wind_size: int,
    overlap: int,
    max_shift: Optional[int] = None,
    flat_wrap: bool = True,
) -> ShiftOperands:
    """Pad the ``[B, H, W]`` frames and split the ``[B, N]`` shifts as the
    TPU kernel's wrapper does (``shift_pallas.py``, clip/floor/frac)."""
    w = wind_size
    n_rows, n_cols = get_field_shape(frame_shape, w, overlap)
    if tuple(frame.shape[-2:]) != tuple(frame_shape):
        raise ValueError(f"frame shape {tuple(frame.shape[-2:])} != {tuple(frame_shape)}")
    if vel_x.shape != (frame.shape[0], n_rows * n_cols) or vel_y.shape != vel_x.shape:
        raise ValueError(
            f"shift maps must be [B, {n_rows * n_cols}] for frames {tuple(frame.shape)}")
    S = max_shift if max_shift is not None else max(w // 2, 1)
    frame = frame.to(torch.float32)
    off = 0
    if flat_wrap:
        frame = flat_wrap_pad(frame, S)
        off = S
    if frame.shape[-2] < w + 1 or frame.shape[-1] < w + 1:
        raise ValueError(f"a {w}+1 px tile does not fit the {tuple(frame.shape[-2:])} frame")
    vx = vel_x.to(torch.float32).clamp(-S, S)
    vy = vel_y.to(torch.float32).clamp(-S, S)
    dy = torch.floor(vy)
    dx = torch.floor(vx)
    return ShiftOperands(
        frame.contiguous(),
        dy.to(torch.int32).contiguous(),
        dx.to(torch.int32).contiguous(),
        (vy - dy).contiguous(),
        (vx - dx).contiguous(),
        off, n_rows, n_cols, w - overlap,
    )


def blend_reference(ops: ShiftOperands, wind_size: int) -> torch.Tensor:
    """The kernel's arithmetic on ``ShiftOperands`` -> ``[B, N, w, w]``."""
    w = wind_size
    T = w + 1
    B, Hp, Wp = ops.frame.shape
    dev = ops.frame.device
    n = torch.arange(ops.n_rows * ops.n_cols, device=dev)
    row0 = torch.div(n, ops.n_cols, rounding_mode="floor") * ops.step + ops.off
    col0 = (n % ops.n_cols) * ops.step + ops.off
    ty = (row0 + ops.dy).clamp(0, Hp - T)
    tx = (col0 + ops.dx).clamp(0, Wp - T)
    ar = torch.arange(T, device=dev)
    idx = ((ty[..., None] + ar)[..., :, None] * Wp
           + (tx[..., None] + ar)[..., None, :])  # [B, N, T, T]
    tile = torch.gather(ops.frame.reshape(B, -1), 1,
                        idx.reshape(B, -1)).reshape(*idx.shape)
    f11 = tile[..., :w, :w]
    f21 = tile[..., :w, 1:]
    f12 = tile[..., 1:, :w]
    f22 = tile[..., 1:, 1:]
    fy = ops.fy[..., None, None]
    fx = ops.fx[..., None, None]
    blend = (
        f11 * ((1.0 - fx) * (1.0 - fy))
        + f21 * (fx * (1.0 - fy))
        + f12 * ((1.0 - fx) * fy)
        + f22 * (fx * fy)
    )
    # integer shift in EITHER axis -> floor corner (reference fallback)
    return torch.where((fy == 0.0) | (fx == 0.0), f11, blend)


def shift_windows_reference(
    frame: torch.Tensor,
    vel_x: torch.Tensor,
    vel_y: torch.Tensor,
    *,
    frame_shape: Tuple[int, int],
    wind_size: int,
    overlap: int,
    max_shift: Optional[int] = None,
    flat_wrap: bool = True,
) -> torch.Tensor:
    """Shifted windows ``[B, N, w, w]`` float32 from ``[B, H, W]`` frames and
    ``[B, N]`` per-window shifts (``[N, w, w]`` from ``[H, W]`` and ``[N]``)."""
    batched = frame.dim() == 3
    if not batched:
        frame, vel_x, vel_y = frame[None], vel_x[None], vel_y[None]
    ops = shift_operands(frame, vel_x, vel_y, frame_shape=frame_shape,
                         wind_size=wind_size, overlap=overlap,
                         max_shift=max_shift, flat_wrap=flat_wrap)
    out = blend_reference(ops, wind_size)
    return out if batched else out[0]
