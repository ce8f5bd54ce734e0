"""The multipass PIV engine over a batch of frame pairs (counterpart of
``torchpiv_tpu/models/multipass.py``).

``MultipassPIV`` maps ``[B, H, W]`` frame pairs to final-pass
``(u, v, invalid)`` fields ``[B, n_rows, n_cols]``: a first pass (window
extraction, DC-folded FFT correlation, gauss3 peak fit with peak-ratio
validation), then N-1 CWS/DWS/DEF refinement passes (spline predictor
upsample, window shift or deformation through the hand-written CUDA
kernels, correlation, peak fit, anti-divergence guards).  The leading pair
axis replaces the JAX package's ``vmap``/``lax.scan``.

Pass semantics are the JAX engine's:

* CWS: the half-shift comes from the predictor BEFORE validation zeroing,
  symmetric -+u/2 bilinear (or, with ``cws_interp="bicubic"``, Keys bicubic)
  shifts, total ``u = 2*(u0/2) + du``;
* DEF: the CWS half-shift plus its gradients on the pass grid (central
  differences, one-sided at the edges, spacing ``step``); every window is
  resampled per pixel with ``-(shift + gradient * offset)`` in frame A and
  ``+`` in frame B, in ``cws_interp``;
* DWS: the predictor is zeroed BEFORE halving and rounding (half to even),
  integer shifts, total ``u = 2*rint(u0/2) + du``;
* guard: revert to the zeroed predictor where ``du > u0 and rint(u0) > 0``
  or where the window failed validation.

``peakfit="pallas"`` runs the fused peak-fit kernel instead of the chain of
torch ops (``"xla"``, the default); both give the same fields.

``use_pallas`` chooses the resampling of the refine passes, as in the JAX
engine (``_use_pallas``): "auto" and "on" run the kernels, "off" the JAX
engine's XLA paths (``ops.shifts.cws_shift``, ``bicubic_cws_shift``,
``dws_shift``, ``ops.deform.def_windows_xla``: per-pixel weights, no clamp
to ``max_shift``).  Under "auto"/"on" the XLA paths also take the windows
beyond the kernels' limits (``shift_pallas_supported``,
``def_pallas_supported``) and bicubic CWS with a ``shift_variant`` other
than "rolls".  ``fused="on"`` keeps its kernel, and pass 1 is the same
either way.  The choice follows from the configuration and the window size
before any launch.

``shift_variant`` selects the bilinear shift kernel of the CWS and DWS
passes (``kernels.shift``: ``"rolls"``, ``"bf16"``, ``"lanephases"``,
``"mxu"``, ``"phases"``), unfused and under ``fused="split"``; an unknown
name runs ``"rolls"``, as in the JAX engine.  ``fused="on"`` and DEF ignore
it.  Three of the variants read the frame in bfloat16, which changes the
result for frames whose values are not exact in bfloat16.

``correlator="matmul"`` with ``dft_precision="default"`` and no window
weights stores the refine passes' windows in bfloat16
(``_window_store_dtype``): the "rolls" and bicubic shift kernels and the
DEF kernel round at the store where the JAX engine passes its
``out_dtype``, and the windows are promoted to float32 where they are
correlated.  The bilinear windows of ``fused="split"`` and ``fused="on"``
stay float32, as in the JAX engine.

Robust-correlation and validation knobs, in the JAX engine's order:

* ``frame_mask`` (a static region-of-interest mask, True = excluded): the
  masked pixels are zeroed before every pass, and a window whose masked
  share reaches ``mask_threshold`` is invalid with zero displacement on
  every pass;
* ``window_weight="gaussian"``: a separable Gaussian taper (sigma = w/4) on
  every window before correlation, after the shift; pass 1 then normalises
  by the mean explicitly;
* ``correlation="rpc"``: robust phase correlation (``ops.correlate``);
* ``subpixel="gauss2d"``: the 9-point fit (``ops.peakfit``);
* after the last pass: velocity limits and the global sigma test, the
  median filter, the second-peak fallback (three rounds, per pair), and
  ``infill="fused"`` (``ops.infill.fused_infill``).

Pass fusion (``fused``), with the JAX engine's rules:

* ``"split"``: every pass correlates and fits in one kernel
  (``kernels.corrfit``), so no correlation map reaches device memory.  It
  applies when ``subpixel == "gauss3"`` and every pass window is a power of
  two in 4..128; the windows come from ``extract_windows`` (pass 1), the
  shift kernels (CWS, DWS) or the deformation kernel (DEF).
* ``"on"``: CWS and DWS passes, and pass 1 with zero shifts, run whole in
  one kernel (``kernels.fused_pass``): neither windows nor maps reach device
  memory.  It applies with ``edge_exact``, bilinear resampling and
  ``subpixel == "gauss3"``, and, in the port, power-of-two windows; DEF
  ignores it.
* Where a mode does not apply the engine runs the unfused chain and does
  not raise, as the JAX engine does.

Stage spans (``utils.profiling``; they record only while ``torch.profiler``
is active and change no result): ``forward`` is one ``piv.call``, tiled by
``piv.input`` (the frames' cast and mask), per pass ``piv.pass<N>.predict``
(refine passes: upsample, half-shift, zeroing, DEF gradients),
``.windows`` (extraction or resampling), ``.correlate`` (window weights and
the correlation, or the ``corrfit`` / ``fused_pass`` launch), ``.peakfit``
(unfused chain) and ``.guard`` (anti-divergence guards, window mask), then
``piv.post`` (``post_pass``), which also counts ``flagged``, the final
field's invalid vectors.

The static operators (spline upsample matrices ``Ay``/``Ax`` between pass
grids, per-pass window origins) are registered buffers.  The predictor
matmuls run in full float32 at the default ``dtype``: on a CUDA device the
engine raises if TF32 is enabled, because a TF32 predictor flips CWS
integer-crossing decisions.

``dtype`` (``config.compute_dtype``) rounds where the JAX engine casts:
the upsample operators and the predictor, pass 1's windows (promoted to
float32 at the correlation) and what the resampling kernels are handed;
the kernels compute in float32 (``config.py`` states the rule).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import PIVConfig, compute_dtype
from ..kernels.corrfit import correlate_peakfit
from ..kernels.deform import def_pallas_supported, def_windows
from ..kernels.fused_pass import fused_piv_pass
from ..kernels.peakfit import peakfit
from ..kernels.shift import shift_pallas_supported, shift_windows
from ..ops.corrfit import corrfit_supported
from ..ops.correlate import correlate_fft, mean_normalize, rpc_filter
from ..ops.deform import def_windows_xla
from ..ops.geometry import get_coordinates, get_field_shape, per_window_origins
from ..ops.infill import fused_infill
from ..ops.peakfit import correlation_to_displacement
from ..ops.shifts import VARIANTS, bicubic_cws_shift, cws_shift, dws_shift
from ..ops.spline import upsample_matrices
from ..ops.validation import (apply_median_filter, global_std_test,
                              second_peak_acceptance, velocity_limits_test)
from ..ops.windows import extract_windows
from ..utils.device import check_no_tf32, resolve_device
from ..utils.profiling import count, engine_call, span


def _gradient(f: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """``jnp.gradient`` along ``dim`` with spacing ``h``, in its arithmetic:
    ``(f[i+1] - f[i-1]) * 0.5 / h`` inside, one-sided differences ``/ h`` at
    the two ends."""
    n = f.shape[dim]
    first = (f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1)) / h
    last = (f.narrow(dim, n - 1, 1) - f.narrow(dim, n - 2, 1)) / h
    inner = (f.narrow(dim, 2, n - 2) - f.narrow(dim, 0, n - 2)) * 0.5 / h
    return torch.cat([first, inner, last], dim=dim)


class MultipassPIV(nn.Module):
    """The multipass engine for one frame shape, on one device."""

    def __init__(self, config: PIVConfig, device="auto",
                 frame_mask: Optional[np.ndarray] = None,
                 mask_threshold: float = 0.5):
        super().__init__()
        self.config = config
        self.schedule = config.pass_schedule()
        self.compute_dtype = getattr(torch, compute_dtype(config.dtype))
        H, W = config.frame_shape
        self.coords = [get_coordinates((H, W), w, o) for w, o in self.schedule]
        self.field_shapes = [get_field_shape((H, W), w, o) for w, o in self.schedule]
        fm = ii = None
        if frame_mask is not None:
            if not 0.0 <= mask_threshold <= 1.0:
                raise ValueError("mask_threshold must be in [0, 1]")
            fm = np.asarray(frame_mask).astype(bool)
            if fm.shape != (H, W):
                raise ValueError(
                    f"frame_mask shape {fm.shape} != frame {config.frame_shape}")
            ii = np.zeros((H + 1, W + 1), np.int64)  # integral image
            ii[1:, 1:] = fm.astype(np.int64).cumsum(0).cumsum(1)
        self.register_buffer("frame_mask", None if fm is None else torch.from_numpy(fm))
        for p, (w, o) in enumerate(self.schedule):
            r0, c0 = per_window_origins((H, W), w, o)
            self.register_buffer(f"origins_{p}", torch.from_numpy(np.stack([r0, c0])))
            masked = None
            if ii is not None:
                cnt = (ii[r0 + w, c0 + w] - ii[r0, c0 + w]
                       - ii[r0 + w, c0] + ii[r0, c0])
                # threshold 0 means "any masked pixel", not "every window"
                need = max(1, int(np.ceil(mask_threshold * w * w)))
                masked = torch.from_numpy((cnt >= need).reshape(self.field_shapes[p]))
            self.register_buffer(f"window_masked_{p}", masked)
            weight = None
            if config.window_weight is not None:
                x = (np.arange(w) - (w - 1) / 2.0) / (w / 4.0)
                g = np.exp(-0.5 * x * x).astype(np.float32)
                weight = torch.from_numpy(np.outer(g, g))
            self.register_buffer(f"weight_{p}", weight)
            rpc = None
            if config.correlation == "rpc":
                rpc = rpc_filter(w, config.rpc_diameter)
            self.register_buffer(f"rpc_{p}", rpc)
        for p in range(1, len(self.schedule)):
            x0, y0 = self.coords[p - 1]
            x1, y1 = self.coords[p]
            Ay, Ax = upsample_matrices(y0[:, 0], x0[0, :], y1[:, 0], x1[0, :])
            self.register_buffer(f"Ay_{p}", torch.from_numpy(Ay).to(self.compute_dtype))
            self.register_buffer(f"Ax_{p}", torch.from_numpy(Ax).to(self.compute_dtype))
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.origins_0.device

    @property
    def origins(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per-pass flat ``[N]`` window origins ``(row0, col0)``."""
        out = []
        for p in range(len(self.schedule)):
            o = getattr(self, f"origins_{p}").cpu().numpy()
            out.append((o[0], o[1]))
        return out

    @property
    def upsamplers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(getattr(self, f"Ay_{p}"), getattr(self, f"Ax_{p}"))
                for p in range(1, len(self.schedule))]

    @property
    def window_masked(self) -> List[Optional[torch.Tensor]]:
        """Per-pass bool ``[R, C]`` masks of the windows that ``frame_mask``
        excludes (None without a mask)."""
        return [getattr(self, f"window_masked_{p}")
                for p in range(len(self.schedule))]

    @property
    def final_coordinates(self) -> Tuple[np.ndarray, np.ndarray]:
        """(x, y) window-centre pixel coordinates of the final pass."""
        return self.coords[-1]

    @property
    def final_field_shape(self) -> Tuple[int, int]:
        return self.field_shapes[-1]

    def _in_dtype(self, frame):
        """A float32 frame rounded to ``dtype``, as the resampling kernels
        of a refine pass are handed it (float32 again: they compute in
        float32)."""
        return frame.to(self.compute_dtype).float()

    def _masked_frame(self, frame):
        """Zero the excluded pixels (no-op without a mask)."""
        if self.frame_mask is None:
            return frame
        return frame.masked_fill(self.frame_mask, 0.0)

    def _apply_window_mask(self, p, u, v, inval, rows=None):
        """Force pass-p masked windows invalid with zero displacement
        (``rows``: the block of window rows the fields hold)."""
        m = self.window_masked[p]
        if m is None:
            return u, v, inval
        if rows is not None:
            m = m[rows[0]:rows[0] + rows[1]]
        m = m.expand(u.shape)
        return (u.masked_fill(m, 0.0), v.masked_fill(m, 0.0),
                m if inval is None else inval | m)

    def _correlate(self, p, aa, bb, dc_normalize=False):
        """Raw circular cross-correlation of pass ``p``'s windows (the
        minimum is subtracted in the peak fit); ``correlation="rpc"`` swaps
        the spectrum product for robust phase correlation."""
        return correlate_fft(aa, bb, dc_normalize,
                             phase_filter=getattr(self, f"rpc_{p}"))

    def _peakfit(self, corr, validate, want_second=False):
        """Sub-pixel fit and validation on raw maps; ``want_second`` also
        returns the second-peak candidates (torch-op chain only: the
        configuration never combines it with the kernel)."""
        cfg = self.config
        maps = corr.reshape(-1, *corr.shape[-2:])
        if cfg.peakfit == "pallas" and not want_second:
            return peakfit(maps, validate, cfg.val_ratio, cfg.validation_window,
                           min_subtract=True)
        return correlation_to_displacement(
            maps, validate, cfg.val_ratio, cfg.validation_window,
            min_subtract=True, fit=cfg.subpixel, return_second=want_second)

    @staticmethod
    def _stage(p: int, name: str):
        """The span of stage ``name`` of pass ``p`` (``piv.pass<p+1>.<name>``:
        passes are numbered from 1)."""
        return span(f"piv.pass{p + 1}.{name}")

    def _use_pallas(self) -> bool:
        """Refine passes resample through the kernels (``use_pallas``
        "auto" or "on": the card stands in for the TPU, whose kernels the
        JAX engine runs there), or through the JAX engine's XLA paths
        ("off"); ``pallas_interpret`` keeps the kernels, as in the JAX
        engine."""
        cfg = self.config
        return cfg.use_pallas != "off" or cfg.pallas_interpret

    def _shift_kernel(self, w: int) -> bool:
        """Pass windows of width ``w`` come from a shift kernel (CWS, DWS):
        not under "off", not for bicubic CWS with a variant other than
        "rolls", and only within the kernels' limits."""
        cfg = self.config
        bicubic = cfg.multipass_mode == "CWS" and cfg.cws_interp == "bicubic"
        return (self._use_pallas()
                and not (bicubic and cfg.shift_variant != "rolls")
                and shift_pallas_supported(w, "bicubic" if bicubic else "bilinear"))

    def _window_origins(self, p, rows=None):
        """Pass ``p``'s flat ``[N]`` window origins on the device, or those
        of the block of window rows ``rows=(org, n)``."""
        r0, c0 = getattr(self, f"origins_{p}")
        if rows is not None:
            C = self.field_shapes[p][1]
            r0, c0 = (t[rows[0] * C:(rows[0] + rows[1]) * C] for t in (r0, c0))
        return r0, c0

    def _window_store_dtype(self) -> torch.dtype:
        """Element type the shift and DEF kernels store windows in (the JAX
        engine's ``_window_store_dtype``): bfloat16 where the matmul DFT at
        ``dft_precision="default"`` correlates them unweighted, float32
        otherwise.  On the TPU that DFT is one bfloat16 pass, whose rounding
        of the windows the store applies; the port correlates in float32,
        so the store's rounding is all of it that remains, as in the JAX
        engine off the TPU.  ``correlator="auto"`` never picks the matmul
        DFT here, as the JAX engine's does not off the TPU."""
        cfg = self.config
        if (cfg.correlator == "matmul" and cfg.dft_precision == "default"
                and cfg.window_weight is None):
            return torch.bfloat16
        return torch.float32

    def _shift_variant(self) -> str:
        """The bilinear shift kernel of the CWS and DWS passes."""
        v = self.config.shift_variant
        return v if v in VARIANTS else "rolls"

    def _fusable_windows(self) -> bool:
        """Every pass window is one the pass-fusion kernels take."""
        return all(corrfit_supported(w) for w, _ in self.schedule)

    def _use_fused(self) -> bool:
        """``fused="on"`` applies (CWS and DWS passes and pass 1)."""
        cfg = self.config
        return (cfg.fused == "on" and cfg.edge_exact
                and cfg.window_weight is None and cfg.cws_interp == "bilinear"
                and cfg.subpixel == "gauss3" and self._fusable_windows())

    def _use_split(self) -> bool:
        """``fused="split"`` applies (every pass)."""
        cfg = self.config
        return (cfg.fused == "split" and cfg.window_weight is None
                and cfg.subpixel == "gauss3" and self._fusable_windows())

    def _corrfit(self, aa, bb, dc_normalize=False):
        """Windows ``[B, N, w, w]`` -> flat ``(u, v, invalid)`` through the
        correlate-and-fit kernel; windows of a narrower type are promoted to
        float32 first, as the JAX correlate-and-fit kernel promotes them."""
        cfg = self.config
        w = aa.shape[-1]
        aa, bb = aa.float(), bb.float()
        return correlate_peakfit(aa.reshape(-1, w, w), bb.reshape(-1, w, w),
                                 cfg.validate, cfg.val_ratio,
                                 cfg.validation_window, dc_normalize)

    def _fused_pass(self, p, frame_a, frame_b, vxa, vya, vxb, vyb,
                    dc_normalize=False):
        """Pass ``p`` whole through the fused kernel, ``[B, N]`` shifts."""
        cfg = self.config
        w, o = self.schedule[p]
        return fused_piv_pass(
            frame_a, frame_b, vxa, vya, vxb, vyb, frame_shape=cfg.frame_shape,
            wind_size=w, overlap=o, validate=cfg.validate,
            val_ratio=cfg.val_ratio, validation_window=cfg.validation_window,
            max_shift=cfg.max_shift, dc_normalize=dc_normalize)

    def first_pass(self, frame_a: torch.Tensor, frame_b: torch.Tensor,
                   want_second: bool = False, rows=None):
        """Zero-order pass on float32 ``[B, H, W]`` frames (``forward`` has
        zeroed the pixels that ``frame_mask`` excludes).  ``want_second``
        (single-pass runs with the second-peak fallback) appends the
        candidate displacement fields to the result.  ``rows=(org, n)``
        computes only window rows ``org .. org+n-1`` (the window split of
        ``parallel.ShardedPIV``), from the frame band that holds them, with
        the unfused correlation and fit."""
        cfg = self.config
        w, o = self.schedule[0]
        B = frame_a.shape[0]
        R, C = self.field_shapes[0]
        if rows is not None:
            org, R = rows
            top = org * (w - o)
            frame_a = frame_a[:, top:top + (R - 1) * (w - o) + w]
            frame_b = frame_b[:, top:top + (R - 1) * (w - o) + w]
        cand = None
        if rows is None and self._use_fused():
            with self._stage(0, "correlate"):
                # zero shifts: plain extraction; the mean normalisation
                # scales the map inside the kernel
                z = torch.zeros((B, R * C), dtype=torch.float32, device=frame_a.device)
                u, v, inval = self._fused_pass(0, frame_a, frame_b, z, z, z, z,
                                               dc_normalize=True)
        else:
            with self._stage(0, "windows"):
                aa = extract_windows(frame_a, w, o).to(self.compute_dtype)
                bb = extract_windows(frame_b, w, o).to(self.compute_dtype)
            if rows is None and self._use_split():
                with self._stage(0, "correlate"):
                    u, v, inval = self._corrfit(aa, bb, dc_normalize=True)
            else:
                with self._stage(0, "correlate"):
                    wgt = self.weight_0
                    if wgt is None:
                        # mean normalisation folded into the spectrum product
                        corr = self._correlate(0, aa, bb, dc_normalize=True)
                    else:
                        # the fold assumes unweighted windows: normalise first
                        corr = self._correlate(0, mean_normalize(aa) * wgt,
                                               mean_normalize(bb) * wgt)
                with self._stage(0, "peakfit"):
                    u, v, inval, *cand = self._peakfit(corr, cfg.validate, want_second)
        with self._stage(0, "guard"):
            shape = (B, R, C)
            u, v, inval = self._apply_window_mask(
                0, u.reshape(shape), v.reshape(shape),
                None if inval is None else inval.reshape(shape), rows)
            if want_second:
                (cu, cv), = cand
                return u, v, inval, (cu.reshape(shape), cv.reshape(shape))
            return u, v, inval

    def _refine_pass(self, p, frame_a, frame_b, u, v, inval, want_second=False,
                     rows=None):
        """One CWS/DWS/DEF refinement pass from grid p-1 to grid p.
        ``want_second`` (the last pass with the second-peak fallback)
        appends the candidate fields ``2 * half-shift + second-peak fit``.
        ``rows=(org, n)`` computes only window rows ``org .. org+n-1`` of
        grid p from the full fields of grid p-1 (the window split of
        ``parallel.ShardedPIV``): the predictor from those rows of ``Ay``,
        the row-block kernels, the unfused correlation and fit."""
        cfg = self.config
        w, o = self.schedule[p]
        B = frame_a.shape[0]
        R, C = self.field_shapes[p]
        Ay, Ax = self.upsamplers[p - 1]
        Ay_rows = Ay
        if rows is not None:
            org, R = rows
            Ay_rows = Ay[org:org + R]

        def up(field, A=Ay_rows):  # spline predictor, [B, R0, C0] -> [B, R, C1]
            return torch.matmul(torch.matmul(A, field.to(self.compute_dtype)), Ax.T)

        with self._stage(p, "predict"):
            u0 = up(u)
            v0 = up(v)
            if inval is not None:
                val0 = up(inval) >= 0.5
            if cfg.multipass_mode in ("CWS", "DEF"):
                # half-shift from the PRE-zeroed predictor
                u2 = u0 / 2.0
                v2 = v0 / 2.0
                if inval is not None:
                    u0 = torch.where(val0, 0.0, u0)
                    v0 = torch.where(val0, 0.0, v0)
            else:  # DWS: predictor zeroed BEFORE rounding
                if inval is not None:
                    u0 = torch.where(val0, 0.0, u0)
                    v0 = torch.where(val0, 0.0, v0)
                u2 = torch.round(u0 / 2.0)  # integer shifts: a pure tile copy
                v2 = torch.round(v0 / 2.0)
            # the kernels take float32 shifts (the values in ``dtype``)
            sx, sy = u2.reshape(B, -1).float(), v2.reshape(B, -1).float()
            maps = None
            if cfg.multipass_mode == "DEF":
                # locally linearised displacement: the half-shift plus its
                # gradient across the window, symmetric between the frames
                step = float(w - o)
                u2f, v2f = u2, v2
                if rows is not None:
                    # the gradients need the rows on either side of the
                    # block: differentiate the full predictor, then take
                    # the block
                    u2f, v2f = up(u, Ay) / 2.0, up(v, Ay) / 2.0
                    u2, v2 = u2f[:, org:org + R], v2f[:, org:org + R]
                    sx, sy = u2.reshape(B, -1).float(), v2.reshape(B, -1).float()
                grads = [_gradient(u2f, step, -1), _gradient(u2f, step, -2),
                         _gradient(v2f, step, -1), _gradient(v2f, step, -2)]
                if rows is not None:
                    grads = [g[:, org:org + R] for g in grads]
                maps = [sx, sy] + [g.reshape(B, -1).float() for g in grads]

        kw = dict(frame_shape=cfg.frame_shape, wind_size=w, overlap=o,
                  max_shift=cfg.max_shift, flat_wrap=cfg.edge_exact)
        if rows is not None:
            kw.update(row_start=org, n_rows_local=R)
        fused_result = None
        if cfg.multipass_mode != "DEF" and rows is None and self._use_fused():
            with self._stage(p, "correlate"):
                # DWS shifts are integer-valued: the kernel's blend
                # degenerates to the floor corner, the integer tile copy
                fused_result = self._fused_pass(p, frame_a, frame_b, -sx, -sy, sx, sy)
        else:
            with self._stage(p, "windows"):
                aa, bb = self._refine_windows(p, frame_a, frame_b, sx, sy, maps,
                                              rows, kw)

        cand = None
        if fused_result is not None:
            du, dv, new_inval = fused_result
        elif rows is None and self._use_split():
            with self._stage(p, "correlate"):
                du, dv, new_inval = self._corrfit(aa, bb)
        else:
            with self._stage(p, "correlate"):
                wgt = getattr(self, f"weight_{p}")
                if wgt is not None:  # weights apply after the shift
                    aa, bb = aa * wgt, bb * wgt
                corr = self._correlate(p, aa, bb)
            with self._stage(p, "peakfit"):
                du, dv, new_inval, *cand = self._peakfit(corr, cfg.validate, want_second)
        with self._stage(p, "guard"):
            shape = (B, R, C)
            du = du.reshape(shape)
            dv = dv.reshape(shape)
            if new_inval is not None:
                new_inval = new_inval.reshape(shape)

            u_new = 2.0 * u2 + du
            v_new = 2.0 * v2 + dv
            # anti-divergence guards
            mask_u = (du > u0) & (torch.round(u0) > 0)
            mask_v = (dv > v0) & (torch.round(v0) > 0)
            if new_inval is not None:
                mask_u = mask_u | new_inval
                mask_v = mask_v | new_inval
            u, v, new_inval = self._apply_window_mask(
                p, torch.where(mask_u, u0, u_new), torch.where(mask_v, v0, v_new),
                new_inval, rows)
            if want_second:
                # the same half-shift the first fit refines, plus the second
                # peak's residual fit
                (du2, dv2), = cand
                return u, v, new_inval, (2.0 * u2 + du2.reshape(shape),
                                         2.0 * v2 + dv2.reshape(shape))
            return u, v, new_inval

    def _refine_windows(self, p, frame_a, frame_b, sx, sy, maps, rows, kw):
        """Pass ``p``'s resampled windows ``(aa, bb)``: DEF (``maps``: the
        half-shift and its four gradients, flat ``[B, N]``) through the
        deformation kernel or its XLA path, CWS and DWS (``sx``, ``sy``)
        through a shift kernel or the XLA paths; ``kw``: the kernels'
        geometry."""
        cfg = self.config
        w = self.schedule[p][0]
        if maps is not None:
            if self._use_pallas() and def_pallas_supported(
                    w, cfg.def_margin, cfg.cws_interp):
                kw.update(margin=cfg.def_margin, interp=cfg.cws_interp,
                          out_dtype=self._window_store_dtype())
                return (def_windows(self._in_dtype(frame_a), *(-m for m in maps), **kw),
                        def_windows(self._in_dtype(frame_b), *maps, **kw))
            # the XLA path: dense per-pixel shifts, in ``dtype``
            xkw = dict(interp=cfg.cws_interp, dtype=self.compute_dtype)
            r0, c0 = self._window_origins(p, rows)
            return (def_windows_xla(frame_a, r0, c0, w, *(-m for m in maps), **xkw).float(),
                    def_windows_xla(frame_b, r0, c0, w, *maps, **xkw).float())
        if self._shift_kernel(w):
            if cfg.multipass_mode == "CWS":  # DWS stays the integer copy
                kw.update(interp=cfg.cws_interp)
            if kw.get("interp", "bilinear") == "bilinear":
                kw.update(variant=self._shift_variant())
            # the store type where the JAX engine's ``_shift`` asks for it:
            # the "rolls" kernels, not the bilinear windows that its split
            # mode takes from the packed kernel at float32
            if cfg.shift_variant == "rolls" and not (
                    rows is None and self._use_split()
                    and cfg.cws_interp == "bilinear"):
                kw.update(out_dtype=self._window_store_dtype())
            return (shift_windows(self._in_dtype(frame_a), -sx, -sy, **kw),
                    shift_windows(self._in_dtype(frame_b), sx, sy, **kw))
        # the XLA paths: per-pixel weights, no clamp, in ``dtype``
        r0, c0 = self._window_origins(p, rows)
        if cfg.multipass_mode == "DWS":
            shift, vx, vy = dws_shift, sx.to(torch.int32), sy.to(torch.int32)
        else:
            shift = bicubic_cws_shift if cfg.cws_interp == "bicubic" else cws_shift
            vx, vy = sx, sy
        return (shift(frame_a, r0, c0, w, -vx, -vy, self.compute_dtype).float(),
                shift(frame_b, r0, c0, w, vx, vy, self.compute_dtype).float())

    def _apply_global_filters(self, u, v, inval):
        """Velocity limits and the global mean +- k*sigma test; windows
        that are already invalid (the static mask among them) stay out of
        the sigma statistics."""
        cfg = self.config
        if cfg.u_limits is not None or cfg.v_limits is not None:
            extra = velocity_limits_test(u, v, cfg.u_limits, cfg.v_limits)
            inval = extra if inval is None else (inval | extra)
        if cfg.global_std is not None:
            inval = global_std_test(u, v, cfg.global_std, inval)
        return inval

    def _apply_second_peak_fallback(self, u, v, inval, cand):
        """The vector-recovery ladder at invalid sites.  Two candidates are
        tried per site: the vector already in place (at a site the peak
        ratio flagged it is the predictor-reverted value) and the fit at the
        second correlation peak.  Each is accepted only when it passes the
        normalized-median test against valid neighbours
        (``second_peak_acceptance``) and the velocity limits; masked windows
        are never rescued.  Three rounds: vectors rescued in one round are
        valid neighbours in the next, so clusters heal from the outside in.
        Every pair of the batch is judged on its own field."""
        cfg = self.config
        cu, cv = cand
        masked = self.window_masked[-1]

        def hard_reject(fu, fv):
            bad = velocity_limits_test(fu, fv, cfg.u_limits, cfg.v_limits)
            return bad if masked is None else bad | masked

        for _ in range(3):
            for ccu, ccv in ((u, v), (cu, cv)):
                ok = second_peak_acceptance(u, v, inval, ccu, ccv,
                                            cfg.fallback_threshold)
                ok = ok & ~hard_reject(ccu, ccv)
                u = torch.where(ok, ccu, u)
                v = torch.where(ok, ccv, v)
                inval = inval & ~ok
        return u, v, inval

    def post_pass(self, u, v, inval, cand=None):
        """The field operations after the last pass on ``[B, R, C]`` fields,
        in order: velocity limits and the global sigma test, the median
        filter, the second-peak fallback (``cand``: the candidate fields,
        or None) and ``infill="fused"``."""
        cfg = self.config
        inval = self._apply_global_filters(u, v, inval)
        if cfg.median_filter is not None:
            inval = apply_median_filter(u, v, inval, cfg.median_filter,
                                        cfg.median_threshold)
        if cand is not None and inval is not None:
            u, v, inval = self._apply_second_peak_fallback(u, v, inval, cand)
        if cfg.infill == "fused" and inval is not None:
            u = fused_infill(u.masked_fill(inval, torch.nan), inval)
            v = fused_infill(v.masked_fill(inval, torch.nan), inval)
        return u, v, inval

    @torch.no_grad()
    def forward(self, frame_a: torch.Tensor, frame_b: torch.Tensor):
        """Raw frames (``[B, H, W]`` or ``[H, W]``, any real dtype) ->
        ``(u, v, invalid)`` on the final grid (``invalid`` is None without
        validation)."""
        check_no_tf32(self.device)
        single = frame_a.dim() == 2
        if single:
            frame_a, frame_b = frame_a[None], frame_b[None]
        if tuple(frame_a.shape[-2:]) != tuple(self.config.frame_shape) or \
                frame_b.shape != frame_a.shape:
            raise ValueError(f"frames {tuple(frame_a.shape)}/{tuple(frame_b.shape)} "
                             f"do not match frame_shape {self.config.frame_shape}")
        cfg = self.config
        B = frame_a.shape[0]
        R, C = self.final_field_shape
        with engine_call(self.device, B, B * R * C):
            # the frames' cast and mask count with the field operations
            with span("piv.input"):
                frame_a = self._masked_frame(frame_a.to(self.device, torch.float32))
                frame_b = self._masked_frame(frame_b.to(self.device, torch.float32))
            last = len(self.schedule) - 1
            want = cfg.second_peak_fallback
            u, v, inval, *cand = self.first_pass(frame_a, frame_b,
                                                 want_second=want and last == 0)
            for p in range(1, last + 1):
                u, v, inval, *cand = self._refine_pass(
                    p, frame_a, frame_b, u, v, inval, want_second=want and p == last)
            with span("piv.post"):
                u, v, inval = self.post_pass(u, v, inval, cand[0] if cand else None)
                count("flagged", inval)
        if single:
            u, v = u[0], v[0]
            inval = None if inval is None else inval[0]
        return u, v, inval
