"""``PIVConfig``: the static configuration of a multipass run.

A twin of ``PIVConfig`` in ``torchpiv_tpu/models/multipass.py``: the same
field names, defaults, ``pass_schedule()`` and validation, so a JAX config
converts one to one (``from_dict``).

Knobs whose only effect is a TPU lowering are accepted and do nothing here:
``shift_maps``, ``extract_variant``, ``complex_mm``, ``correlator`` and
``dft_precision``.  ``shift_variant`` is live: it selects the bilinear shift
kernel of the CWS and DWS passes (``kernels/shift.py``), and a name that is
none of the five runs ``"rolls"``, as in the JAX engine.
The port always correlates in float32, through ``torch.fft`` or inside its
pass-fusion kernels.

``use_pallas`` is live and chooses how a refine pass resamples its windows,
as in the JAX engine (``MultipassPIV._use_pallas``):

* ``"auto"`` (the default) and ``"on"``: the hand-written CUDA kernels
  (their plain versions on the CPU), the semantics of the JAX engine's
  Pallas kernels on the TPU, which the card replaces: per-window weights
  and shifts clamped to ``max_shift``;
* ``"off"``: the JAX engine's XLA paths (``ops.shifts.cws_shift``,
  ``bicubic_cws_shift``, ``dws_shift`` and ``ops.deform.def_windows_xla``):
  per-pixel absolute coordinates, no clamp to ``max_shift``, the
  reference's flat-index clamped addressing.  ``pallas_interpret=True``
  keeps the kernels' semantics, as it does in the JAX engine.

Under ``"auto"``/``"on"`` the engine takes the XLA paths where the JAX
engine does: refine windows beyond the kernels' limits
(``kernels.shift.shift_pallas_supported``,
``kernels.deform.def_pallas_supported``) and bicubic CWS with a
``shift_variant`` other than ``"rolls"``.  ``fused="on"`` runs its kernel
whatever ``use_pallas`` says.

``peakfit="pallas"`` selects the fused CUDA peak-fit kernel; ``"xla"`` (the
default) the chain of torch ops.  ``fused="split"`` runs correlation and
peak fit of every pass in one CUDA kernel, ``fused="on"`` the whole pass
(window shift included); where the JAX engine would silently run its unfused
chain (see ``MultipassPIV``) the port does too.

The robust-correlation and validation knobs (``window_weight``,
``correlation="rpc"``, ``subpixel="gauss2d"``, ``infill="fused"``,
``median_filter``, ``u_limits``/``v_limits``, ``global_std``,
``second_peak_fallback``) are live, with the JAX twin's cross-checks.

``dtype`` casts where the JAX engine casts (``compute_dtype`` names the
element type; the kernels themselves compute and store float32, as the TPU
kernels do after their cast on entry):

* the spline upsample operators and both predictor matmuls of a refine
  pass are in that type (so are the predictor and its half-shift);
* pass 1's windows are rounded to it after extraction, and promoted to
  float32 where they are correlated, as the JAX package's matmul DFT (its
  TPU correlator) promotes them; with window weights pass 1 normalises them
  in that type first;
* the frames that the shift and deformation kernels of a refine pass get
  are rounded to it, and so are the shifts and gradients every resampling
  kernel gets; the whole-pass kernel (``fused="on"``) gets the frame as it
  is, as in the JAX engine;
* the XLA-semantics resampling computes in that type, coordinates, samples
  and weights, as the JAX engine's XLA shifts do, and its windows are
  promoted to float32 where they are correlated.

``"float32"`` and ``"float64"`` compute in float32: with 64-bit mode off,
its default, the JAX package computes ``"float64"`` as float32, and the
port follows that type.  ``"bfloat16"`` and ``"float16"`` round the values
above.  Any other name (an integer type, an 8-bit float) raises
``ValueError`` naming ``dtype``.

What raises ``ValueError`` here and not in the JAX twin:

* ``dtype`` other than the four above;
* ``dtype`` ``"bfloat16"`` or ``"float16"`` with ``correlator="fft"``
  where pass 1 correlates its windows through the FFT (unfused and
  unweighted): the JAX package's FFT takes float32 and float64 only and
  raises there when the engine runs, the port when it is configured;
  ``"auto"`` and ``"matmul"`` take the matmul DFT's promotion above;
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# knob -> predicate on its value that is true when the value is not ported
# (every knob is ported; ``dtype`` refuses non-float types on its own)
NOT_PORTED = {}


def compute_dtype(name) -> str:
    """The element type the engine computes ``dtype=name`` in:
    ``"float32"`` (also for ``"float64"``, as the JAX package computes it
    with 64-bit mode off), ``"bfloat16"`` or ``"float16"``; a numpy alias
    (``"half"``, ``"f4"``) names its type.  Raises ``ValueError`` naming
    ``dtype`` for anything else."""
    if name == "bfloat16":
        return name
    try:
        kind = np.dtype(name).name if isinstance(name, str) else None
    except TypeError:
        kind = None
    if kind not in ("float16", "float32", "float64"):
        raise ValueError(
            f"dtype={name!r}: the port computes in float32 (also for "
            f"'float64'), 'bfloat16' or 'float16' only")
    return "float32" if kind == "float64" else kind


@dataclasses.dataclass(frozen=True)
class PIVConfig:
    """Static configuration of a multipass run (see the JAX twin for each
    knob's meaning)."""

    frame_shape: Tuple[int, int]
    wind_size: int = 64
    overlap: int = 32
    multipass: int = 1
    multipass_mode: str = "CWS"  # "CWS" | "DWS" | "DEF"
    multipass_scale: float = 2.0
    validate: bool = True
    val_ratio: float = 1.2
    validation_window: int = 3
    infill: str = "host"  # "host" | "fused" (on the device) | "none"
    dtype: str = "float32"
    use_pallas: str = "auto"  # "auto" | "on" (kernels) | "off" (XLA semantics)
    pallas_interpret: bool = False  # True keeps the kernels' semantics
    edge_exact: bool = True  # flat-wrap padding of the shifted frames
    max_shift: Optional[int] = None  # shift clamp, default wind // 2
    shift_variant: str = "rolls"  # "rolls" | "bf16" | "lanephases" | "mxu" | "phases"
    shift_maps: str = "rows"  # TPU lowering only: no effect
    correlator: str = "auto"  # TPU lowering only: always f32 torch.fft
    peakfit: str = "xla"  # "xla" (torch ops) | "pallas" (fused kernel)
    subpixel: str = "gauss3"  # "gauss3" | "gauss2d" (torch-op fit only)
    dft_precision: str = "high"  # TPU lowering only: always f32 torch.fft
    complex_mm: str = "real"  # TPU lowering only: no effect
    fused: str = "auto"  # "auto" | "off" | "split" | "on" (pass fusion)
    median_filter: Optional[str] = None  # None | "median" | "normmedian"
    median_threshold: float = 2.0
    u_limits: Optional[Tuple[float, float]] = None  # (min, max) px
    v_limits: Optional[Tuple[float, float]] = None  # (min, max) px
    global_std: Optional[float] = None  # mean +- k*sigma over valid vectors
    cws_interp: str = "bilinear"  # "bilinear" | "bicubic" (CWS and DEF)
    def_margin: int = 2  # DEF only
    window_weight: Optional[str] = None  # None | "gaussian"
    correlation: str = "scc"  # "scc" | "rpc" (robust phase correlation)
    rpc_diameter: float = 2.8
    second_peak_fallback: bool = False  # vector recovery at invalid sites
    fallback_threshold: float = 2.0
    extract_variant: str = "stack"  # TPU lowering only: no effect

    def _pass1_fused(self) -> bool:
        """Pass 1 runs in a pass-fusion kernel in the JAX engine (which
        casts its windows to float32) rather than through the correlator."""
        if self.subpixel != "gauss3":
            return False
        if self.fused == "on":
            return (self.edge_exact and self.window_weight is None
                    and self.cws_interp == "bilinear")
        return (self.fused == "split" and self.window_weight is None
                and all(4 <= w <= 128 and w & (w - 1) == 0
                        for w, _ in self.pass_schedule()))

    def pass_schedule(self) -> List[Tuple[int, int]]:
        """Per-pass (wind_size, overlap), shrunk by int floor-division per
        pass exactly like the reference constructor."""
        sched = [(self.wind_size, self.overlap)]
        w, o = self.wind_size, self.overlap
        for _ in range(self.multipass - 1):
            w = int(w // self.multipass_scale)
            o = int(o // self.multipass_scale)
            sched.append((w, o))
        return sched

    @classmethod
    def from_dict(cls, d: dict) -> "PIVConfig":
        """Config from ``dataclasses.asdict`` of a JAX ``PIVConfig`` (or any
        mapping of field names); raises on unknown and unported knobs."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown PIVConfig fields {unknown}")
        kw = dict(d)
        for k in ("frame_shape", "u_limits", "v_limits"):
            if kw.get(k) is not None:
                kw[k] = tuple(kw[k])
        return cls(**kw)

    def __post_init__(self):
        # the JAX twin's checks, in its order
        if self.overlap >= self.wind_size:
            raise ValueError("Overlap has to be smaller than the window_size")
        H, W = self.frame_shape
        if self.wind_size > H or self.wind_size > W:
            raise ValueError("window size cannot be larger than the image")
        if self.multipass_mode not in ("CWS", "DWS", "DEF"):
            raise ValueError(f"unknown multipass_mode {self.multipass_mode!r}")
        if self.infill not in ("host", "fused", "none"):
            raise ValueError(f"unknown infill {self.infill!r}")
        if self.use_pallas not in ("auto", "on", "off"):
            raise ValueError(f"unknown use_pallas {self.use_pallas!r}")
        if self.fused not in ("auto", "split", "on", "off"):
            raise ValueError(f"unknown fused {self.fused!r}")
        if self.window_weight not in (None, "gaussian"):
            raise ValueError(f"unknown window_weight {self.window_weight!r}")
        if self.cws_interp not in ("bilinear", "bicubic"):
            raise ValueError(f"unknown cws_interp {self.cws_interp!r}")
        if self.window_weight is not None and self.fused == "on":
            raise ValueError("window_weight is not supported by the fused "
                             "pass kernel; use fused='off'")
        if self.correlator not in ("auto", "fft", "matmul"):
            raise ValueError(f"unknown correlator {self.correlator!r}")
        if self.correlation not in ("scc", "rpc"):
            raise ValueError(f"unknown correlation {self.correlation!r}")
        if self.correlation == "rpc":
            if self.fused in ("split", "on"):
                raise ValueError("correlation='rpc' runs in the XLA chain; "
                                 "the fused pass kernels do not support it "
                                 "(use fused='off')")
            if not self.rpc_diameter > 0:
                raise ValueError("rpc_diameter must be a positive particle "
                                 "image diameter in px")
        if self.second_peak_fallback:
            if not self.validate:
                raise ValueError("second_peak_fallback requires validate=True")
            if self.peakfit == "pallas":
                raise ValueError("second_peak_fallback runs in the XLA "
                                 "peak-fit chain; use peakfit='xla'")
            if self.fused in ("split", "on"):
                raise ValueError("second_peak_fallback is not supported by "
                                 "the fused pass kernels (use fused='off')")
            if not self.fallback_threshold > 0:
                raise ValueError("fallback_threshold must be positive")
        if self.dft_precision not in ("default", "high", "highest"):
            raise ValueError(f"unknown dft_precision {self.dft_precision!r}")
        if self.complex_mm not in ("direct", "real", "gauss"):
            raise ValueError(f"unknown complex_mm {self.complex_mm!r}")
        if self.subpixel not in ("gauss3", "gauss2d"):
            raise ValueError(f"unknown subpixel {self.subpixel!r}")
        if self.subpixel != "gauss3" and self.peakfit == "pallas":
            raise ValueError("subpixel='gauss2d' requires peakfit='xla'")
        if self.extract_variant not in ("stack", "tilemajor"):
            raise ValueError(
                f"unknown extract_variant {self.extract_variant!r}")
        if self.shift_maps not in ("rows", "prefetch"):
            raise ValueError(f"unknown shift_maps {self.shift_maps!r}")
        if not 1 <= self.def_margin <= 8:
            raise ValueError("def_margin must be in [1, 8]")
        for name, lim in (("u_limits", self.u_limits),
                          ("v_limits", self.v_limits)):
            if lim is not None and (len(lim) != 2 or not lim[0] < lim[1]):
                raise ValueError(f"{name} must be (min, max) with min < max")
        if self.global_std is not None and self.global_std <= 0:
            raise ValueError("global_std must be a positive sigma multiple")
        for p, (w, o) in enumerate(self.pass_schedule()):
            if w < 4 or o >= w or o < 0:
                raise ValueError(
                    f"pass {p + 1} degenerates to window {w}, overlap {o} — "
                    f"reduce multipass/multipass_scale"
                )
        low = compute_dtype(self.dtype) != "float32"
        if low and self.correlator == "fft" and self.window_weight is None \
                and not self._pass1_fused():
            raise ValueError(
                f"dtype={self.dtype!r} with correlator='fft': pass 1 hands "
                f"its {self.dtype} windows to the FFT, which takes float32 "
                f"and float64 only in the JAX package; use correlator="
                f"'auto' or 'matmul' (the windows promoted to float32)")
        # what the port does not implement yet
        for knob, unported in NOT_PORTED.items():
            value = getattr(self, knob)
            if unported(value):
                raise ValueError(
                    f"{knob}={value!r} is not ported to the PyTorch engine yet")
