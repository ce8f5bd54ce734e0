"""Wrapper of the hand-written CUDA peak-fit kernel (``csrc/peakfit.cu``),
the port of ``correlation_to_displacement_pallas``.

For CPU tensors it runs the plain PyTorch version
(``ops.peakfit.correlation_to_displacement``); for CUDA tensors it launches
the kernel on the current stream or raises.  ``peakfit.launches`` counts
launches.  ``describe`` reports what the compiler made of the kernel's
instance for a map size: a warp a map up to 128 px (the map in registers
up to 32 px, in chunks beyond), a block a map above.

The kernel adds ``EPS`` after subtracting the map's minimum, as the TPU
kernel does; the plain version adds ``EPS - min`` in one step (see
``ops/peakfit.py``).  The results are equal unless a sample that the fit
reads lies within about 2 of the minimum.  Up to 128 px a map that holds
a NaN fits as in the plain version (its first NaN is the peak, u = v = 0);
the block instance for larger maps passes NaN samples over.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..ops.peakfit import correlation_to_displacement
from . import _build

MAX_MAP_BYTES = 227 * 1024  # one map sits in a block's shared memory


def describe(d: int) -> Dict[str, int]:
    """What the compiler made of the kernel's instance for ``d x d`` maps
    (``_build.describe``): registers, local bytes, shared bytes, threads and
    maps (``windows``) a block."""
    if d < 1 or d * d * 4 > MAX_MAP_BYTES:
        raise ValueError(f"peakfit: no instance for {d} px maps")
    return _build.describe("peakfit", d)


def launch(corr: torch.Tensor, validate: bool, val_ratio: float,
           validation_window: int, min_subtract: bool):
    """Launch the kernel on contiguous float32 CUDA maps ``[N, d, k]``."""
    n, d, k = corr.shape
    dev = corr.device
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    invalid = torch.empty(n, dtype=torch.bool, device=dev) if validate else None
    fn = _build.function(
        "peakfit", "peakfit_f32",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                      ctypes.c_int,
                                                      ctypes.c_void_p])
    if n:
        with torch.cuda.device(dev):
            rc = fn(corr.data_ptr(), u.data_ptr(), v.data_ptr(),
                    invalid.data_ptr() if validate else None,
                    n, d, k, validation_window, val_ratio, int(min_subtract),
                    torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch("peakfit", rc)
        peakfit.launches += 1
    return u, v, invalid


def peakfit(
    corr: torch.Tensor,
    validate: bool = True,
    val_ratio: float = 1.2,
    validation_window: int = 3,
    min_subtract: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``[N, d, k]`` float32 correlation maps (square) -> ``(u, v, invalid)``
    as ``ops.peakfit.correlation_to_displacement`` gives them, in one fused
    kernel: first peak, gauss3 sub-pixel fit, peak-ratio validation."""
    if corr.dim() != 3 or corr.shape[1] != corr.shape[2]:
        raise ValueError(f"peakfit takes square maps [N, d, d], not {tuple(corr.shape)}")
    if corr.dtype != torch.float32:
        raise ValueError(f"peakfit takes float32 maps, not {corr.dtype}")
    if corr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"peakfit: unsupported device {corr.device}")
    if corr.shape[1] * corr.shape[2] * 4 > MAX_MAP_BYTES:
        raise ValueError(f"peakfit: a {corr.shape[1]} px map exceeds "
                         f"{MAX_MAP_BYTES} bytes of shared memory")
    if corr.device.type == "cpu":
        return correlation_to_displacement(
            corr, validate, val_ratio, validation_window, min_subtract=min_subtract)
    return launch(corr.contiguous(), validate, float(val_ratio),
                  int(validation_window), min_subtract)


peakfit.launches = 0
