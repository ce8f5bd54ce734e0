"""Multi-frame (multi-Δt) PIV for time-resolved sequences (counterpart of
``torchpiv_tpu/models/multidt.py``; ``MultiDtResult`` and
``merge_multi_dt`` are copied).

Where the acquisition rate oversamples the slow parts of a flow,
correlating frames further apart multiplies the displacement while the
~0.02-0.05 px fit noise stays constant: the standard dynamic-range booster
of time-resolved PIV (Hain & Kähler, Exp. Fluids 42 (2007)).

Per snapshot the engine runs at several frame separations; each window
keeps the LARGEST separation whose displacement is still valid, small
enough for the correlation (``max_disp_frac`` of the first pass's window)
and consistent with the single-frame estimate.  Velocities are returned in
px/frame.

The port runs the separations as one engine call over a batch of k pairs
(frame ``t`` repeated, frames ``t + k``), where the JAX package makes k
calls of one pair.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import PIVConfig
from .multipass import MultipassPIV


@dataclass
class MultiDtResult:
    """Merged fields for one snapshot: ``u``/``v`` in px/frame,
    ``invalid`` where no separation produced a usable vector, ``dt_map``
    the per-window separation chosen (frames)."""

    u: np.ndarray
    v: np.ndarray
    invalid: np.ndarray
    dt_map: np.ndarray


def merge_multi_dt(
    fields: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    separations: Sequence[int],
    wind_size: int,
    max_disp_frac: float = 0.25,
    consistency_px: float = 1.0,
) -> MultiDtResult:
    """Merge per-separation engine outputs into one field.

    ``fields[i] = (u, v, invalid)`` measured at ``separations[i]`` frames
    apart (displacements in px at that separation).  Selection per
    window, preferring the largest separation: the candidate must be
    valid, its displacement magnitude below ``max_disp_frac * wind_size``
    (the one-quarter rule, against the FIRST-pass window — the engine's
    predictor lets later passes follow larger displacements), and its
    implied px/frame velocity within ``consistency_px`` (divided by its
    separation) of the smallest separation's — a long-Δt vector that
    disagrees with the short-Δt one is a decorrelated/peak-hopped match,
    not a refinement.  Where the base separation is itself invalid the
    consistency check is waived (there is nothing trustworthy to compare
    against).  ``dt_map`` is 0 where no separation produced a usable
    vector, so saved files keep the validity information.
    """
    if len(fields) != len(separations) or not fields:
        raise ValueError("fields and separations must match and be "
                         "non-empty")
    order = np.argsort(separations)
    seps = [int(separations[i]) for i in order]
    fs = [fields[i] for i in order]
    u0, v0, bad0 = (np.asarray(a, dtype=np.float64) for a in fs[0])
    base_bad = bad0 > 0
    base_u = np.where(base_bad, np.nan, u0 / seps[0])
    base_v = np.where(base_bad, np.nan, v0 / seps[0])

    u_out = base_u.copy()
    v_out = base_v.copy()
    dt_map = np.where(base_bad, 0, seps[0]).astype(np.int64)
    max_disp = max_disp_frac * wind_size

    for k, (uk, vk, badk) in zip(seps[1:], fs[1:]):
        uk = np.asarray(uk, dtype=np.float64)
        vk = np.asarray(vk, dtype=np.float64)
        badk = np.asarray(badk, dtype=bool)
        with np.errstate(invalid="ignore"):
            consistent = ((np.abs(uk / k - base_u) < consistency_px / k)
                          & (np.abs(vk / k - base_v) < consistency_px / k))
        ok = (~badk
              & (np.hypot(uk, vk) < max_disp)
              & (base_bad | consistent))
        u_out = np.where(ok, uk / k, u_out)
        v_out = np.where(ok, vk / k, v_out)
        dt_map = np.where(ok, k, dt_map)

    invalid = ~np.isfinite(u_out)
    return MultiDtResult(u=np.nan_to_num(u_out), v=np.nan_to_num(v_out),
                         invalid=invalid, dt_map=dt_map)


class MultiDtPIV(nn.Module):
    """Run the multipass engine at several frame separations and merge.

    >>> mdt = MultiDtPIV(cfg, separations=(1, 2, 4))
    >>> res = mdt(frames, t)       # frames [T, H, W]; needs t + 4 < T
    >>> res.u                      # px/frame, best separation per window
    """

    def __init__(self, config: PIVConfig, separations: Sequence[int] = (1, 2, 4),
                 max_disp_frac: float = 0.25, consistency_px: float = 1.0,
                 device="auto"):
        super().__init__()
        seps = sorted(int(s) for s in separations)
        if not seps or seps[0] < 1 or len(set(seps)) != len(seps):
            raise ValueError(f"bad separations {separations}")
        self.separations = seps
        self.config = config
        self.max_disp_frac = float(max_disp_frac)
        self.consistency_px = float(consistency_px)
        self.engine = MultipassPIV(config, device=device)

    def forward(self, frames, t: int = 0) -> MultiDtResult:
        """``frames`` ``[T, H, W]`` (numpy or a tensor) -> the merged field of
        snapshot ``t``."""
        if frames.ndim != 3:
            raise ValueError(f"expected [T, H, W] frames, got {tuple(frames.shape)}")
        if t + self.separations[-1] >= frames.shape[0]:
            raise ValueError(
                f"snapshot {t} + max separation {self.separations[-1]} "
                f"exceeds the {frames.shape[0]}-frame sequence")
        k = len(self.separations)
        sel = torch.as_tensor(frames)[[t] + [t + s for s in self.separations]]
        sel = sel.to(self.engine.device)
        u, v, inval = self.engine(sel[:1].expand(k, -1, -1), sel[1:])
        u, v = u.cpu().numpy(), v.cpu().numpy()
        # without validation every window counts as valid
        inval = np.zeros(u.shape, bool) if inval is None else inval.cpu().numpy()
        fields = [(u[i], v[i], inval[i]) for i in range(k)]
        # quarter rule against the FIRST pass window: later passes ride
        # the predictor, so the first pass bounds the capture range
        return merge_multi_dt(fields, self.separations,
                              self.config.pass_schedule()[0][0],
                              self.max_disp_frac, self.consistency_px)
