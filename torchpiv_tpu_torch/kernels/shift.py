"""Wrapper of the hand-written CUDA window-shift kernels
(``csrc/shift_windows.cu`` and ``csrc/shift_windows_bicubic.cu``), the port
of ``shift_windows_pallas``.

For CPU tensors it runs the plain PyTorch version
(``ops.shifts.blend_reference`` or ``blend_reference_bicubic``); for CUDA
tensors it launches the kernel on the current stream or raises.
``shift_windows.launches`` counts launches of the bilinear kernel and
``shift_windows_bicubic.launches`` those of the bicubic one.

``packed=True`` (bilinear only) writes the lane-packed layout of the JAX
package's pass-fusion kernels (``ops/packing.py``) straight from the kernel.
The port's engine does not use it: its own kernels read ``[N, w, w]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..config import MAX_BICUBIC_WIND, MAX_SHIFT_WIND
from ..ops.packing import pack_windows, packed_width
from ..ops.shifts import (ShiftOperands, blend_reference,
                          blend_reference_bicubic, shift_operands)
from . import _build

# the limits of the TPU kernels, kept so that both engines take the same
# configurations; (w+1)^2 f32 = 66 KB of shared memory at w = 128
MAX_WIND = {"bilinear": MAX_SHIFT_WIND, "bicubic": MAX_BICUBIC_WIND}


def launch(ops: ShiftOperands, wind_size: int, interp: str = "bilinear",
           packed: bool = False) -> torch.Tensor:
    """Launch the kernel on CUDA ``ShiftOperands`` -> ``[B, N, w, w]``, or
    with ``packed`` (bilinear only) ``[B, n_rows, w, Lp]``."""
    cubic = interp == "bicubic"
    name = "shift_windows_bicubic" if cubic else "shift_windows"
    B, Hp, Wp = ops.frame.shape
    dev = ops.frame.device
    shape = (B, ops.n_rows * ops.n_cols, wind_size, wind_size)
    layout = ()  # the bicubic kernel has no packed output
    if not cubic:
        Lp = packed_width(ops.n_cols, wind_size) if packed else 0
        layout = (int(packed), Lp // wind_size)
        if packed:
            shape = (B, ops.n_rows, wind_size, Lp)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    fn = _build.function(
        name, f"{name}_f32",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * (8 + len(layout))
        + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(ops.frame.data_ptr(), ops.dy.data_ptr(), ops.dx.data_ptr(),
                ops.fy.data_ptr(), ops.fx.data_ptr(), out.data_ptr(),
                B, Hp, Wp, ops.n_rows, ops.n_cols, wind_size, ops.step, ops.off,
                *layout, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, rc)
    if interp == "bicubic":
        shift_windows_bicubic.launches += 1
    else:
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
    interp: str = "bilinear",
    out_dtype: torch.dtype = torch.float32,
    packed: bool = False,
) -> torch.Tensor:
    """Per-window shifted windows ``[B, N, w, w]`` float32 from ``[B, H, W]``
    frames and ``[B, N]`` shifts in pixels (``[N, w, w]`` from ``[H, W]`` and
    ``[N]``); integer-valued shifts give the DWS integer tile copy.
    ``interp`` is ``"bilinear"`` or ``"bicubic"`` (Keys, a = -0.5).
    ``packed`` gives the lane-packed ``[B, n_rows, w, Lp]`` layout instead
    (``ops.packing.pack_windows`` of the standard output; bilinear only)."""
    if interp not in MAX_WIND:
        raise ValueError(f"unknown interp {interp!r}")
    if packed and interp != "bilinear":
        raise ValueError("packed output is bilinear only")
    if wind_size > MAX_WIND[interp]:
        raise ValueError(f"shift_windows: wind_size={wind_size} > "
                         f"{MAX_WIND[interp]} ({interp})")
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
                         max_shift=max_shift, flat_wrap=flat_wrap, interp=interp)
    if frame.device.type == "cpu":
        blend = blend_reference_bicubic if interp == "bicubic" else blend_reference
        out = blend(ops, wind_size)
        if packed:
            out = pack_windows(out, ops.n_rows, ops.n_cols, wind_size)
    else:
        out = launch(ops, wind_size, interp, packed)
    return out if batched else out[0]


def shift_windows_bicubic(frame, vel_x, vel_y, **kw) -> torch.Tensor:
    """``shift_windows`` with ``interp="bicubic"``: the bicubic kernel under
    its own name and launch count."""
    return shift_windows(frame, vel_x, vel_y, interp="bicubic", **kw)


shift_windows.launches = 0
shift_windows_bicubic.launches = 0
