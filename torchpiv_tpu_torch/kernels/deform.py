"""Wrapper of the hand-written CUDA window-deformation kernel
(``csrc/def_windows.cu``), the port of ``def_windows_pallas``.

For CPU tensors it runs the plain PyTorch version
(``ops.deform.def_reference``); for CUDA tensors it launches the kernel on
the current stream or raises.  ``def_windows.launches`` counts launches.
``row_start``/``n_rows_local`` run it on a block of window rows, as the TPU
kernel takes ``row0`` by scalar prefetch.  ``out_dtype`` (float32,
bfloat16 or float16) is the element type of the kernel's stores, as in the
TPU wrapper: it computes in float32 and rounds only at the store
(``csrc/store.cuh``), so the plain version is the float32 result cast with
``.to(out_dtype)``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..ops.deform import DefOperands, def_operands, def_reference
from . import _build
from .shift import STORE_SYMBOLS, check_store


MAX_DEF_TILE = 129  # the TPU kernel's limit on the tile side


def def_tile(wind_size: int, margin: int, interp: str) -> int:
    """Side of the frame tile one DEF window samples from."""
    return wind_size + 2 * margin + (4 if interp == "bicubic" else 1)


def def_pallas_supported(wind_size: int, margin: int = 2,
                         interp: str = "bilinear") -> bool:
    """Whether the deformation kernel takes windows of this size (the TPU
    kernel's predicate, ``torchpiv_tpu/kernels/def_pallas.py:61-70``): the
    engine sends larger windows to ``ops.deform.def_windows_xla``."""
    return def_tile(wind_size, margin, interp) <= MAX_DEF_TILE


def describe(wind_size: int, margin: int, interp: str) -> Dict[str, int]:
    """What the compiler made of the kernel's instance for ``interp`` and
    the launch for ``wind_size`` and ``margin`` (``_build.describe``):
    registers, local bytes, shared bytes, threads and windows a block."""
    check_tile(wind_size, margin, interp)
    return _build.describe("def_windows", wind_size, margin,
                           int(interp == "bicubic"))


def check_tile(wind_size: int, margin: int, interp: str) -> None:
    if interp not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown interp {interp!r}")
    if not def_pallas_supported(wind_size, margin, interp):
        raise ValueError(f"def_windows: wind_size={wind_size} margin={margin} "
                         f"interp={interp!r} needs a "
                         f"{def_tile(wind_size, margin, interp)} px tile > "
                         f"{MAX_DEF_TILE}")


def launch(ops: DefOperands, wind_size: int,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the kernel on CUDA ``DefOperands`` -> ``[B, N, w, w]``, over
    the operands' window rows, stored in ``out_dtype``."""
    B, Hp, Wp = ops.frame.shape
    dev = ops.frame.device
    out = torch.empty((B, ops.n_rows * ops.n_cols, wind_size, wind_size),
                      dtype=out_dtype, device=dev)
    fn = _build.function(
        "def_windows", f"def_windows_{STORE_SYMBOLS[out_dtype]}",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(ops.frame.data_ptr(), ops.dy.data_ptr(), ops.dx.data_ptr(),
                ops.fy.data_ptr(), ops.fx.data_ptr(),
                ops.gyi.data_ptr(), ops.gyj.data_ptr(),
                ops.gxi.data_ptr(), ops.gxj.data_ptr(), out.data_ptr(),
                B, Hp, Wp, ops.n_rows, ops.n_cols, wind_size, ops.step, ops.off,
                ops.row_start, ops.margin, int(ops.cubic),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("def_windows", rc)
    def_windows.launches += 1
    return out


def def_windows(
    frame: torch.Tensor,
    vel_x: torch.Tensor,
    vel_y: torch.Tensor,
    dudx: torch.Tensor,
    dudy: torch.Tensor,
    dvdx: torch.Tensor,
    dvdy: torch.Tensor,
    *,
    frame_shape: Tuple[int, int],
    wind_size: int,
    overlap: int,
    max_shift: Optional[int] = None,
    margin: int = 2,
    flat_wrap: bool = True,
    interp: str = "bilinear",
    out_dtype: torch.dtype = torch.float32,
    row_start: int = 0,
    n_rows_local: Optional[int] = None,
) -> torch.Tensor:
    """Deformed windows ``[B, N, w, w]`` in ``out_dtype`` from ``[B, H, W]`` frames,
    ``[B, N]`` per-window centre shifts in pixels and ``[B, N]`` displacement
    gradients in px per px (``[N, w, w]`` from ``[H, W]`` and ``[N]``).  The
    offset applied at a pixel is ``vel + d/dx * joff + d/dy * ioff`` with
    ``ioff, joff`` its signed offsets from the window centre; the residual
    beyond the centre's integer shift saturates at the margin.
    ``row_start``/``n_rows_local`` select a block of window rows (the maps
    are then ``[B, n_rows_local * n_cols]``)."""
    check_tile(wind_size, margin, interp)
    check_store("def_windows", out_dtype)
    if frame.device.type not in ("cpu", "cuda"):
        raise ValueError(f"def_windows: unsupported device {frame.device}")
    maps = (vel_x, vel_y, dudx, dudy, dvdx, dvdy)
    batched = frame.dim() == 3
    if not batched:
        frame = frame[None]
        maps = tuple(m[None] for m in maps)
    if any(m.device != frame.device for m in maps):
        raise ValueError("frame and per-window maps must be on one device")
    ops = def_operands(frame, *maps, frame_shape=frame_shape,
                       wind_size=wind_size, overlap=overlap,
                       max_shift=max_shift, margin=margin,
                       flat_wrap=flat_wrap, interp=interp,
                       row_start=row_start, n_rows_local=n_rows_local)
    if frame.device.type == "cpu":
        out = def_reference(ops, wind_size).to(out_dtype)  # the kernel rounds at the store
    else:
        out = launch(ops, wind_size, out_dtype)
    return out if batched else out[0]


def_windows.launches = 0
