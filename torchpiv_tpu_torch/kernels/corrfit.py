"""Wrapper of the hand-written CUDA correlate-and-fit kernel
(``csrc/corrfit.cu``), the port of ``correlate_peakfit_pallas``.

For CPU tensors it runs the plain PyTorch version
(``ops.corrfit.correlate_peakfit_reference``); for CUDA tensors it launches
the kernel on the current stream or raises.  ``correlate_peakfit.launches``
counts launches.

The kernel reads the standard ``[N, w, w]`` window layout, not the TPU
kernel's lane-packed one (``ops/packing.py``).  Kernel and plain version sum
in different orders: they agree within about 1e-4 px RMS on valid windows,
not to the last bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ..ops.corrfit import (MAX_WIND, MIN_WIND, correlate_peakfit_reference,
                           corrfit_supported, twiddle_table)
from . import _build


@functools.lru_cache(maxsize=32)
def twiddles(wind_size: int, device: torch.device) -> torch.Tensor:
    """``[w/2, 2]`` float32 table ``(cos, -sin)(2*pi*j/w)``, computed in
    float64 on the host and rounded once.  The kernels take the table in
    host memory and pass it on as a kernel parameter."""
    return twiddle_table(wind_size).to(device).contiguous()


def describe(name: str, wind_size: int) -> Dict[str, int]:
    """What the compiler made of the instance of ``csrc/<name>.cu``
    (``"corrfit"`` or ``"fused_pass"``) for ``wind_size``: registers a
    thread, bytes of local memory a thread (spills and stack), bytes of
    shared memory a block, threads and windows a block."""
    check_windows(name, wind_size)
    return _build.describe(name, wind_size)


def check_windows(name: str, wind_size: int) -> None:
    if not corrfit_supported(wind_size):
        raise ValueError(f"{name}: wind_size={wind_size} is not a power of two "
                         f"in {MIN_WIND}..{MAX_WIND}")


def launch(windows_a: torch.Tensor, windows_b: torch.Tensor, validate: bool,
           val_ratio: float, validation_window: int, dc_normalize: bool):
    """Launch the kernel on contiguous float32 CUDA windows ``[N, w, w]``."""
    n, w, _ = windows_a.shape
    dev = windows_a.device
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    invalid = torch.empty(n, dtype=torch.bool, device=dev) if validate else None
    tw = twiddles(w, torch.device("cpu"))
    fn = _build.function(
        "corrfit", "corrfit_f32",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    if n:
        with torch.cuda.device(dev):
            rc = fn(windows_a.data_ptr(), windows_b.data_ptr(), tw.data_ptr(),
                    u.data_ptr(), v.data_ptr(),
                    invalid.data_ptr() if validate else None,
                    n, w, validation_window, val_ratio, int(dc_normalize),
                    torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch("corrfit", rc)
        correlate_peakfit.launches += 1
    return u, v, invalid


def correlate_peakfit(
    windows_a: torch.Tensor,
    windows_b: torch.Tensor,
    validate: bool = True,
    val_ratio: float = 1.2,
    validation_window: int = 3,
    dc_normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``[N, w, w]`` float32 window pairs (``w`` a power of two in 4..128)
    -> flat ``(u, v, invalid)`` as ``correlate_peakfit_reference`` gives
    them, in one kernel: cross-correlation, first peak, gauss3 sub-pixel
    fit, peak-ratio validation.  No correlation map is stored."""
    if windows_a.dim() != 3 or windows_a.shape[1] != windows_a.shape[2]:
        raise ValueError("correlate_peakfit takes square windows [N, w, w], "
                         f"not {tuple(windows_a.shape)}")
    if windows_b.shape != windows_a.shape:
        raise ValueError(f"window tensors differ: {tuple(windows_a.shape)} "
                         f"and {tuple(windows_b.shape)}")
    check_windows("correlate_peakfit", windows_a.shape[-1])
    if windows_a.dtype != torch.float32 or windows_b.dtype != torch.float32:
        raise ValueError("correlate_peakfit takes float32 windows, not "
                         f"{windows_a.dtype} and {windows_b.dtype}")
    if windows_a.device != windows_b.device:
        raise ValueError("both window tensors must be on one device")
    if windows_a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"correlate_peakfit: unsupported device {windows_a.device}")
    if windows_a.device.type == "cpu":
        return correlate_peakfit_reference(windows_a, windows_b, validate, val_ratio,
                                           validation_window, dc_normalize)
    return launch(windows_a.contiguous(), windows_b.contiguous(), validate,
                  float(val_ratio), int(validation_window), dc_normalize)


correlate_peakfit.launches = 0
