"""Wrapper of the hand-written CUDA window-shift kernel
(``csrc/shift_windows.cu``), the port of ``shift_windows_pallas``.

For CPU tensors it runs the plain PyTorch version
(``ops.shifts.blend_reference``); for CUDA tensors it launches the kernel on
the current stream or raises.  ``shift_windows.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..ops.shifts import ShiftOperands, blend_reference, shift_operands
from . import _build

MAX_WIND = 128  # (w+1)^2 f32 tile = 66 KB of shared memory at w = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("shift_windows")
    fn = lib.shift_windows_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.shift_windows_error_string.restype = ctypes.c_char_p
        lib.shift_windows_error_string.argtypes = [ctypes.c_int]
    return lib


def launch(ops: ShiftOperands, wind_size: int) -> torch.Tensor:
    """Launch the kernel on CUDA ``ShiftOperands`` -> ``[B, N, w, w]``."""
    B, Hp, Wp = ops.frame.shape
    dev = ops.frame.device
    out = torch.empty((B, ops.n_rows * ops.n_cols, wind_size, wind_size),
                      dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.shift_windows_f32(
            ops.frame.data_ptr(), ops.dy.data_ptr(), ops.dx.data_ptr(),
            ops.fy.data_ptr(), ops.fx.data_ptr(), out.data_ptr(),
            B, Hp, Wp, ops.n_rows, ops.n_cols, wind_size, ops.step, ops.off,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.shift_windows_error_string(rc).decode()
        raise RuntimeError(f"shift_windows launch failed: {msg} ({rc})")
    shift_windows.launches += 1
    return out


def shift_windows(
    frame: torch.Tensor,
    vel_x: torch.Tensor,
    vel_y: torch.Tensor,
    *,
    frame_shape: Tuple[int, int],
    wind_size: int,
    overlap: int,
    max_shift: Optional[int] = None,
    flat_wrap: bool = True,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-window shifted windows ``[B, N, w, w]`` float32 from ``[B, H, W]``
    frames and ``[B, N]`` shifts in pixels (``[N, w, w]`` from ``[H, W]`` and
    ``[N]``); integer-valued shifts give the DWS integer tile copy."""
    if wind_size > MAX_WIND:
        raise ValueError(f"shift_windows: wind_size={wind_size} > {MAX_WIND}")
    if out_dtype != torch.float32:
        raise ValueError(f"shift_windows stores float32 only, not {out_dtype}")
    if frame.device.type not in ("cpu", "cuda"):
        raise ValueError(f"shift_windows: unsupported device {frame.device}")
    batched = frame.dim() == 3
    if not batched:
        frame, vel_x, vel_y = frame[None], vel_x[None], vel_y[None]
    if vel_x.device != frame.device or vel_y.device != frame.device:
        raise ValueError("frame and shift maps must be on one device")
    ops = shift_operands(frame, vel_x, vel_y, frame_shape=frame_shape,
                         wind_size=wind_size, overlap=overlap,
                         max_shift=max_shift, flat_wrap=flat_wrap)
    if frame.device.type == "cpu":
        out = blend_reference(ops, wind_size)
    else:
        out = launch(ops, wind_size)
    return out if batched else out[0]


shift_windows.launches = 0
