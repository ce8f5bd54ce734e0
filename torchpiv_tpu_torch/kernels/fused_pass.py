"""Wrapper of the hand-written CUDA whole-pass kernel
(``csrc/fused_pass.cu``), the port of ``fused_piv_pass``.

For CPU tensors it runs the plain PyTorch version
(``ops.corrfit.fused_pass_reference``); for CUDA tensors it launches the
kernel on the current stream or raises.  ``fused_piv_pass.launches`` counts
launches.

The frames are padded with the flat-wrap pad and the shifts clipped and
split into floor and fraction by the same torch ops that feed
``shift_windows`` (``ops.shifts.shift_operands``), so the windows the kernel
correlates are bit for bit those of ``shift_windows``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..ops.corrfit import fused_pass_reference
from ..ops.shifts import ShiftOperands, shift_operands
from . import _build
from .corrfit import check_windows, twiddles


def launch(ops_a: ShiftOperands, ops_b: ShiftOperands, wind_size: int,
           validate: bool, val_ratio: float, validation_window: int,
           dc_normalize: bool):
    """Launch the kernel on the CUDA ``ShiftOperands`` of the two frames ->
    ``(u, v, invalid)``, each ``[B, N]``."""
    B, Hp, Wp = ops_a.frame.shape
    dev = ops_a.frame.device
    shape = (B, ops_a.n_rows * ops_a.n_cols)
    u = torch.empty(shape, dtype=torch.float32, device=dev)
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    invalid = torch.empty(shape, dtype=torch.bool, device=dev) if validate else None
    tw = twiddles(wind_size, torch.device("cpu"))
    fn = _build.function(
        "fused_pass", "fused_pass_f32",
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(ops_a.frame.data_ptr(), ops_b.frame.data_ptr(),
                ops_a.dy.data_ptr(), ops_a.dx.data_ptr(),
                ops_a.fy.data_ptr(), ops_a.fx.data_ptr(),
                ops_b.dy.data_ptr(), ops_b.dx.data_ptr(),
                ops_b.fy.data_ptr(), ops_b.fx.data_ptr(), tw.data_ptr(),
                u.data_ptr(), v.data_ptr(),
                invalid.data_ptr() if validate else None,
                B, Hp, Wp, ops_a.n_rows, ops_a.n_cols, wind_size, ops_a.step,
                ops_a.off, validation_window, val_ratio, int(dc_normalize),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("fused_pass", rc)
    fused_piv_pass.launches += 1
    return u, v, invalid


def fused_piv_pass(
    frame_a: torch.Tensor,
    frame_b: torch.Tensor,
    vxa: torch.Tensor,
    vya: torch.Tensor,
    vxb: torch.Tensor,
    vyb: torch.Tensor,
    *,
    frame_shape: Tuple[int, int],
    wind_size: int,
    overlap: int,
    validate: bool = True,
    val_ratio: float = 1.2,
    validation_window: int = 3,
    max_shift: Optional[int] = None,
    dc_normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One whole pass: ``[B, H, W]`` frames and ``[B, N]`` per-window shifts
    of each frame in pixels (``[H, W]`` and ``[N]`` for one pair) ->
    ``(u, v, invalid)`` of the shifts' shape.  CWS passes ``-u/2`` and
    ``+u/2``, the first pass zeros with ``dc_normalize``, DWS integer-valued
    shifts.  Edges follow the flat-wrap rule; ``wind_size`` is a power of two
    in 4..128."""
    check_windows("fused_piv_pass", wind_size)
    if frame_a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_piv_pass: unsupported device {frame_a.device}")
    if frame_a.shape != frame_b.shape:
        raise ValueError(f"frames differ: {tuple(frame_a.shape)} and "
                         f"{tuple(frame_b.shape)}")
    maps = (vxa, vya, vxb, vyb)
    batched = frame_a.dim() == 3
    if not batched:
        frame_a, frame_b = frame_a[None], frame_b[None]
        maps = tuple(m[None] for m in maps)
    if any(t.device != frame_a.device for t in (frame_b, *maps)):
        raise ValueError("frames and shift maps must be on one device")
    kw = dict(frame_shape=frame_shape, wind_size=wind_size, overlap=overlap,
              max_shift=max_shift)
    if frame_a.device.type == "cpu":
        out = fused_pass_reference(
            frame_a, frame_b, *maps, validate=validate, val_ratio=val_ratio,
            validation_window=validation_window, dc_normalize=dc_normalize, **kw)
    else:
        ops_a = shift_operands(frame_a, maps[0], maps[1], flat_wrap=True, **kw)
        ops_b = shift_operands(frame_b, maps[2], maps[3], flat_wrap=True, **kw)
        out = launch(ops_a, ops_b, wind_size, validate, float(val_ratio),
                     int(validation_window), dc_normalize)
    if batched:
        return out
    return tuple(None if t is None else t[0] for t in out)


fused_piv_pass.launches = 0
