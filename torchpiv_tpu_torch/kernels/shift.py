"""Wrapper of the hand-written CUDA window-shift kernels
(``csrc/shift_windows.cu``, ``csrc/shift_windows_bicubic.cu`` and the four
bilinear variants ``csrc/shift_windows_{bf16,lanephases,mxu,phases}.cu``),
the port of ``shift_windows_pallas``.

For CPU tensors it runs the plain PyTorch version
(``ops.shifts.blend_reference_variant`` or ``blend_reference_bicubic``); for
CUDA tensors it launches the kernel on the current stream or raises: a
variant never steps down to another kernel or to the plain version.
``shift_windows.launches`` counts launches of the bilinear kernel
(``variant="rolls"``), ``shift_windows_bicubic.launches`` those of the
bicubic one, and ``shift_windows_<variant>.launches`` those of a variant.

The bilinear kernel, the bicubic one, ``"bf16"``, ``"lanephases"`` and
``"phases"`` keep a window in a warp's registers (a tile row a coalesced
load, neighbours by shuffle, no shared memory); ``describe`` reports what
the compiler made of each of their instances.  The variants take what the TPU wrapper takes for
them: bilinear only, no ``packed`` output, float32 output.

``out_dtype`` is the element type of the bilinear and bicubic kernels'
stores, as in the TPU wrapper: float32, bfloat16 or float16 (any other
raises ``ValueError``).  The kernels compute in float32 whatever it is and
round only at the store, to nearest even (``csrc/store.cuh``; one C entry
point a type, ``STORE_SYMBOLS``), so a narrow store equals the plain
version's float32 result cast with ``.to(out_dtype)`` and writes half the
bytes.  ``"bf16"``,
``"mxu"`` and ``"phases"`` compute on the padded frame rounded to bfloat16
(round to nearest even, after the flat-wrap pad): ``"mxu"`` and
``"phases"`` read a bfloat16 copy of it (``BF16_FRAME_VARIANTS``),
``"bf16"`` reads the float32 frame itself and rounds each sample as it
loads it; ``"lanephases"`` reads it as it is, on the same body.

``row_start`` and ``n_rows_local`` run every kernel on a block of window
rows (the maps and the output cover just those rows, the frame is the whole
one): each kernel takes the block's first row and is launched over its
rows only, as the TPU kernels take ``row0`` by scalar prefetch.

``packed=True`` (bilinear only) writes the lane-packed layout of the JAX
package's pass-fusion kernels (``ops/packing.py``) straight from the kernel.
The port's engine does not use it: its own kernels read ``[N, w, w]``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..ops.packing import pack_windows, packed_width
from ..ops.shifts import (VARIANTS, ShiftOperands, blend_reference_bicubic,
                          blend_reference_variant, shift_operands)
from . import _build

# the limits of the TPU kernels, kept so that both engines send the same
# windows to the kernels and the rest to the XLA-semantics shifts
MAX_SHIFT_WIND = 128  # the bilinear kernels
MAX_BICUBIC_WIND = 125  # the bicubic kernel
MAX_WIND = {"bilinear": MAX_SHIFT_WIND, "bicubic": MAX_BICUBIC_WIND}
# the kernels with a ``<name>_describe`` entry, and the widths they take
DESCRIBED = {"shift_windows": MAX_SHIFT_WIND,
             "shift_windows_bicubic": MAX_BICUBIC_WIND,
             "shift_windows_bf16": MAX_SHIFT_WIND,
             "shift_windows_phases": MAX_SHIFT_WIND,
             "shift_windows_lanephases": MAX_SHIFT_WIND}
# the variants whose kernel reads a bfloat16 copy of the padded frame
BF16_FRAME_VARIANTS = ("mxu", "phases")
# the store types of the bilinear, bicubic and deformation kernels, and the
# suffix of each one's C entry point (``csrc/store.cuh``)
STORE_SYMBOLS = {torch.float32: "f32", torch.bfloat16: "store_bf16",
                 torch.float16: "store_f16"}


def check_store(name: str, out_dtype: torch.dtype) -> None:
    """Raise ``ValueError`` unless kernel ``name`` can store ``out_dtype``."""
    if out_dtype not in STORE_SYMBOLS:
        raise ValueError(f"{name}: out_dtype {out_dtype} is none of float32, "
                         f"bfloat16 and float16")


def shift_pallas_supported(wind_size: int, interp: str = "bilinear") -> bool:
    """Whether the shift kernels take windows of this size (the TPU
    kernel's predicate, ``torchpiv_tpu/kernels/shift_pallas.py:301-310``):
    the engine sends larger windows to ``ops.shifts.cws_shift``,
    ``bicubic_cws_shift`` or ``dws_shift``."""
    return wind_size <= MAX_WIND[interp]


def describe(wind_size: int, name: str = "shift_windows") -> Dict[str, int]:
    """What the compiler made of kernel ``name``'s instance for
    ``wind_size`` (``_build.describe``): registers, local bytes, shared
    bytes, threads and windows a block."""
    if name not in DESCRIBED:
        raise ValueError(f"no describe entry for {name!r}")
    if not 1 <= wind_size <= DESCRIBED[name]:
        raise ValueError(f"{name}: wind_size={wind_size} not in "
                         f"1..{DESCRIBED[name]}")
    return _build.describe(name, wind_size)


def launch(ops: ShiftOperands, wind_size: int, interp: str = "bilinear",
           packed: bool = False, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the kernel on CUDA ``ShiftOperands`` -> ``[B, N, w, w]``, or
    with ``packed`` (bilinear only) ``[B, n_rows, w, Lp]``, over the
    operands' window rows, stored in ``out_dtype``."""
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
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    fn = _build.function(
        name, f"{name}_{STORE_SYMBOLS[out_dtype]}",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * (9 + len(layout))
        + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(ops.frame.data_ptr(), ops.dy.data_ptr(), ops.dx.data_ptr(),
                ops.fy.data_ptr(), ops.fx.data_ptr(), out.data_ptr(),
                B, Hp, Wp, ops.n_rows, ops.n_cols, wind_size, ops.step, ops.off,
                ops.row_start, *layout, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, rc)
    if interp == "bicubic":
        shift_windows_bicubic.launches += 1
    else:
        shift_windows.launches += 1
    return out


def variant_frame(ops: ShiftOperands, variant: str) -> torch.Tensor:
    """The frame a variant's kernel reads: for ``"bf16"`` and
    ``"lanephases"`` ``ops.frame`` itself (the first rounds each sample as
    it loads it); for ``BF16_FRAME_VARIANTS`` ``ops.frame`` cast to
    bfloat16, its rows padded with zeros to the pitch the kernel's vector
    loads need (the clamps keep every tile inside the unpadded width)."""
    if variant not in BF16_FRAME_VARIANTS:
        return ops.frame.contiguous()
    Wp = ops.frame.shape[-1]
    pitch = -(-(Wp + 2) // 8) * 8
    # zeros pad alike before and after the cast
    return torch.nn.functional.pad(ops.frame.to(torch.bfloat16),
                                   (0, pitch - Wp)).contiguous()


def launch_variant(ops: ShiftOperands, wind_size: int, variant: str,
                   frame: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel of ``variant`` on CUDA ``ShiftOperands`` ->
    ``[B, N, w, w]``.  ``frame`` is ``variant_frame(ops, variant)`` when the
    caller has it already."""
    name = f"shift_windows_{variant}"
    B, Hp, Wp = ops.frame.shape
    dev = ops.frame.device
    if frame is None:
        frame = variant_frame(ops, variant)
    pitch = frame.shape[-1]
    out = torch.empty((B, ops.n_rows * ops.n_cols, wind_size, wind_size),
                      dtype=torch.float32, device=dev)
    fn = _build.function(
        name, f"{name}_f32",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(frame.data_ptr(), ops.dy.data_ptr(), ops.dx.data_ptr(),
                ops.fy.data_ptr(), ops.fx.data_ptr(), out.data_ptr(), B, Hp, Wp,
                pitch, ops.n_rows, ops.n_cols, wind_size, ops.step, ops.off,
                ops.row_start, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, rc)
    VARIANT_WRAPPERS[variant].launches += 1
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
    variant: str = "rolls",
    row_start: int = 0,
    n_rows_local: Optional[int] = None,
) -> torch.Tensor:
    """Per-window shifted windows ``[B, N, w, w]`` in ``out_dtype`` from ``[B, H, W]``
    frames and ``[B, N]`` shifts in pixels (``[N, w, w]`` from ``[H, W]`` and
    ``[N]``); integer-valued shifts give the DWS integer tile copy.
    ``interp`` is ``"bilinear"`` or ``"bicubic"`` (Keys, a = -0.5).
    ``packed`` gives the lane-packed ``[B, n_rows, w, Lp]`` layout instead
    (``ops.packing.pack_windows`` of the standard output; bilinear only).
    ``variant`` selects one of the bilinear kernels (``ops.shifts.VARIANTS``);
    any other than ``"rolls"`` refuses bicubic, ``packed`` and an
    ``out_dtype`` other than float32, as the TPU wrapper does.
    ``row_start``/``n_rows_local`` select window rows ``row_start ..
    row_start + n_rows_local - 1`` (the maps are then ``[B, n_rows_local *
    n_cols]``; the default is the whole grid)."""
    if interp not in MAX_WIND:
        raise ValueError(f"unknown interp {interp!r}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown shift variant {variant!r}")
    if variant != "rolls":
        if interp != "bilinear":
            raise ValueError("bicubic requires the plain 'rolls' variant")
        if packed:
            raise ValueError("packed output requires the 'rolls' variant")
        if out_dtype != torch.float32:
            raise ValueError("out_dtype is supported by the 'rolls'/bicubic "
                             "kernels only")
    if packed and interp != "bilinear":
        raise ValueError("packed output is bilinear only")
    if not shift_pallas_supported(wind_size, interp):
        raise ValueError(f"shift_windows: wind_size={wind_size} > "
                         f"{MAX_WIND[interp]} ({interp})")
    check_store("shift_windows", out_dtype)
    if frame.device.type not in ("cpu", "cuda"):
        raise ValueError(f"shift_windows: unsupported device {frame.device}")
    batched = frame.dim() == 3
    if not batched:
        frame, vel_x, vel_y = frame[None], vel_x[None], vel_y[None]
    if vel_x.device != frame.device or vel_y.device != frame.device:
        raise ValueError("frame and shift maps must be on one device")
    ops = shift_operands(frame, vel_x, vel_y, frame_shape=frame_shape,
                         wind_size=wind_size, overlap=overlap,
                         max_shift=max_shift, flat_wrap=flat_wrap, interp=interp,
                         row_start=row_start, n_rows_local=n_rows_local)
    if frame.device.type == "cpu":
        if interp == "bicubic":
            out = blend_reference_bicubic(ops, wind_size)
        else:
            out = blend_reference_variant(ops, wind_size, variant)
        out = out.to(out_dtype)  # the kernels round at the store
        if packed:
            out = pack_windows(out, ops.n_rows, ops.n_cols, wind_size)
    elif variant != "rolls":
        out = launch_variant(ops, wind_size, variant)
    else:
        out = launch(ops, wind_size, interp, packed, out_dtype)
    return out if batched else out[0]


def shift_windows_bicubic(frame, vel_x, vel_y, **kw) -> torch.Tensor:
    """``shift_windows`` with ``interp="bicubic"``: the bicubic kernel under
    its own name and launch count."""
    return shift_windows(frame, vel_x, vel_y, interp="bicubic", **kw)


def shift_windows_bf16(frame, vel_x, vel_y, **kw) -> torch.Tensor:
    """``shift_windows`` with ``variant="bf16"``: the window shift of the
    frame rounded to bfloat16, a window in a warp's registers, under its
    own name and launch count."""
    return shift_windows(frame, vel_x, vel_y, variant="bf16", **kw)


def shift_windows_lanephases(frame, vel_x, vel_y, **kw) -> torch.Tensor:
    """``shift_windows`` with ``variant="lanephases"``: the window shift of
    the float32 frame on the body of ``"bf16"``, a window in a warp's
    registers, under its own name and launch count."""
    return shift_windows(frame, vel_x, vel_y, variant="lanephases", **kw)


def shift_windows_mxu(frame, vel_x, vel_y, **kw) -> torch.Tensor:
    """``shift_windows`` with ``variant="mxu"``: the kernel that places the
    tile with tensor-core selection products."""
    return shift_windows(frame, vel_x, vel_y, variant="mxu", **kw)


def shift_windows_phases(frame, vel_x, vel_y, **kw) -> torch.Tensor:
    """``shift_windows`` with ``variant="phases"``: the window shift of the
    bfloat16 frame, a window in a warp's registers."""
    return shift_windows(frame, vel_x, vel_y, variant="phases", **kw)


VARIANT_WRAPPERS = {"bf16": shift_windows_bf16,
                    "lanephases": shift_windows_lanephases,
                    "mxu": shift_windows_mxu, "phases": shift_windows_phases}

shift_windows.launches = 0
shift_windows_bicubic.launches = 0
for _wrapper in VARIANT_WRAPPERS.values():
    _wrapper.launches = 0
