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

The static operators (spline upsample matrices ``Ay``/``Ax`` between pass
grids, per-pass window origins) are registered buffers.  The predictor
matmuls run in full float32: on a CUDA device the engine raises if TF32 is
enabled, because a TF32 predictor flips CWS integer-crossing decisions.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ..config import PIVConfig
from ..kernels.corrfit import correlate_peakfit
from ..kernels.deform import def_windows
from ..kernels.fused_pass import fused_piv_pass
from ..kernels.peakfit import peakfit
from ..kernels.shift import shift_windows
from ..ops.corrfit import corrfit_supported
from ..ops.correlate import correlate_fft
from ..ops.geometry import get_coordinates, get_field_shape, per_window_origins
from ..ops.peakfit import correlation_to_displacement
from ..ops.spline import upsample_matrices
from ..ops.windows import extract_windows
from ..utils.device import check_no_tf32, resolve_device


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

    def __init__(self, config: PIVConfig, device="auto"):
        super().__init__()
        self.config = config
        self.schedule = config.pass_schedule()
        H, W = config.frame_shape
        self.coords = [get_coordinates((H, W), w, o) for w, o in self.schedule]
        self.field_shapes = [get_field_shape((H, W), w, o) for w, o in self.schedule]
        for p, (w, o) in enumerate(self.schedule):
            r0, c0 = per_window_origins((H, W), w, o)
            self.register_buffer(f"origins_{p}", torch.from_numpy(np.stack([r0, c0])))
        for p in range(1, len(self.schedule)):
            x0, y0 = self.coords[p - 1]
            x1, y1 = self.coords[p]
            Ay, Ax = upsample_matrices(y0[:, 0], x0[0, :], y1[:, 0], x1[0, :])
            self.register_buffer(f"Ay_{p}", torch.from_numpy(Ay.astype(np.float32)))
            self.register_buffer(f"Ax_{p}", torch.from_numpy(Ax.astype(np.float32)))
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
    def final_coordinates(self) -> Tuple[np.ndarray, np.ndarray]:
        """(x, y) window-centre pixel coordinates of the final pass."""
        return self.coords[-1]

    @property
    def final_field_shape(self) -> Tuple[int, int]:
        return self.field_shapes[-1]

    def _peakfit(self, corr, validate):
        cfg = self.config
        fit = peakfit if cfg.peakfit == "pallas" else correlation_to_displacement
        return fit(corr.reshape(-1, *corr.shape[-2:]), validate, cfg.val_ratio,
                   cfg.validation_window, min_subtract=True)

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
        correlate-and-fit kernel."""
        cfg = self.config
        w = aa.shape[-1]
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

    def first_pass(self, frame_a: torch.Tensor, frame_b: torch.Tensor):
        """Zero-order pass on float32 ``[B, H, W]`` frames."""
        cfg = self.config
        w, o = self.schedule[0]
        B = frame_a.shape[0]
        if self._use_fused():
            # zero shifts: plain extraction; the mean normalisation scales
            # the map inside the kernel
            z = torch.zeros((B, self.field_shapes[0][0] * self.field_shapes[0][1]),
                            dtype=torch.float32, device=frame_a.device)
            u, v, inval = self._fused_pass(0, frame_a, frame_b, z, z, z, z,
                                           dc_normalize=True)
        else:
            aa = extract_windows(frame_a, w, o)
            bb = extract_windows(frame_b, w, o)
            if self._use_split():
                u, v, inval = self._corrfit(aa, bb, dc_normalize=True)
            else:
                # mean normalisation folded into the spectrum product
                corr = correlate_fft(aa, bb, dc_normalize=True)
                u, v, inval = self._peakfit(corr, cfg.validate)
        shape = (B, *self.field_shapes[0])
        return (u.reshape(shape), v.reshape(shape),
                None if inval is None else inval.reshape(shape))

    def _refine_pass(self, p, frame_a, frame_b, u, v, inval):
        """One CWS/DWS/DEF refinement pass from grid p-1 to grid p."""
        cfg = self.config
        w, o = self.schedule[p]
        B = frame_a.shape[0]
        Ay, Ax = self.upsamplers[p - 1]

        def up(field):  # spline predictor, [B, R0, C0] -> [B, R1, C1]
            return torch.matmul(torch.matmul(Ay, field.to(torch.float32)), Ax.T)

        u0 = up(u)
        v0 = up(v)
        if inval is not None:
            val0 = up(inval) >= 0.5

        kw = dict(frame_shape=cfg.frame_shape, wind_size=w, overlap=o,
                  max_shift=cfg.max_shift, flat_wrap=cfg.edge_exact)
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
        sx, sy = u2.reshape(B, -1), v2.reshape(B, -1)
        fused_result = None
        if cfg.multipass_mode != "DEF" and self._use_fused():
            # DWS shifts are integer-valued: the kernel's blend degenerates
            # to the floor corner, the integer tile copy
            fused_result = self._fused_pass(p, frame_a, frame_b, -sx, -sy, sx, sy)
        elif cfg.multipass_mode == "DEF":
            # locally linearised displacement: the half-shift plus its
            # gradient across the window, symmetric between the frames
            step = float(w - o)
            maps = [sx, sy] + [g.reshape(B, -1) for g in (
                _gradient(u2, step, -1), _gradient(u2, step, -2),
                _gradient(v2, step, -1), _gradient(v2, step, -2))]
            kw.update(margin=cfg.def_margin, interp=cfg.cws_interp)
            aa = def_windows(frame_a, *(-m for m in maps), **kw)
            bb = def_windows(frame_b, *maps, **kw)
        else:
            if cfg.multipass_mode == "CWS":  # DWS stays the integer copy
                kw.update(interp=cfg.cws_interp)
            aa = shift_windows(frame_a, -sx, -sy, **kw)
            bb = shift_windows(frame_b, sx, sy, **kw)

        if fused_result is not None:
            du, dv, new_inval = fused_result
        elif self._use_split():
            du, dv, new_inval = self._corrfit(aa, bb)
        else:
            corr = correlate_fft(aa, bb)
            du, dv, new_inval = self._peakfit(corr, cfg.validate)
        shape = (B, *self.field_shapes[p])
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
        return (torch.where(mask_u, u0, u_new), torch.where(mask_v, v0, v_new),
                new_inval)

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
        frame_a = frame_a.to(self.device, torch.float32)
        frame_b = frame_b.to(self.device, torch.float32)
        u, v, inval = self.first_pass(frame_a, frame_b)
        for p in range(1, len(self.schedule)):
            u, v, inval = self._refine_pass(p, frame_a, frame_b, u, v, inval)
        if single:
            u, v = u[0], v[0]
            inval = None if inval is None else inval[0]
        return u, v, inval
