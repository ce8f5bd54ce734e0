"""Measurement-quality diagnostics (counterpart of
``torchpiv_tpu/stats/quality.py``).

* peak-locking degree: the bias of sub-pixel displacements toward integer
  values (Christensen, Exp. Fluids 36 (2004)); host numpy on final fields,
  copied;
* signal-to-noise map: the per-window first/second correlation-peak ratio
  as a continuous field;
* peak-width and uncertainty maps: the correlation peak's fitted Gaussian
  widths, and the first-order uncertainty of the 3-point fit.

The three maps are torch ops on the device of their frames: the windows
(``extract_windows``), the mean-normalised FFT correlation
(``correlate_fft(dc_normalize=True)``, where the JAX package calls its
matmul DFT; the two agree to float32 accuracy), the peak by ``argmax`` and
the samples around it by ``gather``.  The second-peak exclusion is the
peak fit's (``ops.peakfit.exclusion_mask``).  They take numpy frames, or
tensors, which they leave on their device; ``device`` places numpy frames
(``"auto"``: the CUDA card).  They return numpy ``[R, C]`` maps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.correlate import correlate_fft
from ..ops.geometry import get_field_shape
from ..ops.peakfit import EPS, exclusion_mask
from ..ops.windows import extract_windows
from ..utils.device import resolve_device


def fractional_histogram(
    u: np.ndarray, bins: int = 20, mask: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Histogram of the fractional parts of a displacement component.

    Returns ``(counts, edges)`` over ``frac(u) in [0, 1)``; ``mask`` marks
    vectors to EXCLUDE (e.g. the engine's invalid mask).
    """
    u = np.asarray(u, dtype=np.float64)
    if mask is not None:
        u = u[~np.asarray(mask, dtype=bool)]
    frac = np.mod(u.ravel(), 1.0)
    frac = frac[np.isfinite(frac)]
    return np.histogram(frac, bins=bins, range=(0.0, 1.0))


def peak_locking_degree(
    u: np.ndarray, bins: int = 20, mask: Optional[np.ndarray] = None
) -> float:
    """Degree of peak locking C in [0, 1] for one displacement component.

    ``C = (max(h) - min(h)) / max(h)`` over the fractional-displacement
    histogram h (Christensen 2004, eq. 1).  0 = uniform fractions (no
    locking); values above ~0.3 indicate biased sub-pixel fits (particle
    images too small for the 3-point Gaussian fit).
    """
    counts, _ = fractional_histogram(u, bins=bins, mask=mask)
    total = counts.sum()
    if total == 0:
        return 0.0
    h = counts.astype(np.float64) / total
    hi = float(h.max())
    if hi == 0.0:
        return 0.0
    return (hi - float(h.min())) / hi


class _Peak:
    """The flat correlation maps ``[n, kd]`` of a frame pair and their
    first peak ``m``, with the samples at flat offsets from it."""

    def __init__(self, frame_a, frame_b, wind_size: int, overlap: int, device):
        fa, fb = (f if isinstance(f, torch.Tensor)
                  else torch.from_numpy(np.ascontiguousarray(f)).to(resolve_device(device))
                  for f in (frame_a, frame_b))
        self.field_shape = get_field_shape(tuple(fa.shape), wind_size, overlap)
        aa = extract_windows(fa, wind_size, overlap).float()
        bb = extract_windows(fb.to(fa.device), wind_size, overlap).float()
        corr = correlate_fft(aa, bb, dc_normalize=True)
        n, self.d, self.k = corr.shape
        self.kd = self.d * self.k
        self.flat = corr.reshape(n, self.kd)
        self.m = torch.argmax(self.flat, dim=-1)

    def at(self, offset: int, flat=None) -> torch.Tensor:
        """The samples at flat index ``m + offset``, clamped to the map
        (only interior peaks are read there)."""
        flat = self.flat if flat is None else flat
        idx = (self.m + offset).clamp(0, self.kd - 1)
        return torch.gather(flat, 1, idx[:, None])[:, 0]

    def interior(self) -> torch.Tensor:
        """Peaks with a full 3-point stencil on both axes."""
        row = torch.div(self.m, self.k, rounding_mode="floor")
        col = self.m % self.k
        return (row > 0) & (row < self.d - 1) & (col > 0) & (col < self.k - 1)

    def out(self, *maps):
        R, C = self.field_shape
        got = tuple(t.cpu().numpy().reshape(R, C) for t in maps)
        return got[0] if len(got) == 1 else got


def snr_map(frame_a, frame_b, wind_size: int, overlap: int,
            validation_window: int = 3, device="auto") -> np.ndarray:
    """First-peak / second-peak correlation ratio per window, ``[R, C]``.

    The continuous form of the reference's validation quantity, with its
    exclusion: SNR ~ 1 means no dominant particle-pattern match (poor
    seeding, laser dropout, out-of-plane motion); rules of thumb flag
    windows below ~1.3-2.
    """
    pk = _Peak(frame_a, frame_b, wind_size, overlap, device)
    shift = EPS - pk.flat.amin(dim=-1)
    cm = pk.at(0) + shift
    excl = exclusion_mask(pk.m, pk.k, pk.kd, validation_window)
    masked = pk.flat.masked_fill(excl, -torch.inf)
    c2 = torch.clamp(masked.amax(dim=-1) + shift, min=EPS)
    return pk.out(cm / c2)


def peak_width_map(frame_a, frame_b, wind_size: int, overlap: int,
                   device="auto") -> Tuple[np.ndarray, np.ndarray]:
    """Fitted Gaussian half-widths of the correlation peak, ``([R, C] sx,
    [R, C] sy)`` in pixels.

    The 3-point log-Gaussian fit also gives the peak's standard deviation
    per axis, ``sigma = sqrt(-1 / (2*c2))`` with ``c2 = (ln c_l - 2 ln c_m +
    ln c_r) / 2``.  The correlation peak of ideal particle images is their
    autocorrelation, so ``d_tau ~ 2*sqrt(2)*sigma`` estimates the effective
    particle-image diameter.  Windows whose peak sits on the map's border
    return NaN.
    """
    pk = _Peak(frame_a, frame_b, wind_size, overlap, device)
    flat = pk.flat + (EPS - pk.flat.amin(dim=-1, keepdim=True))
    cm = pk.at(0, flat)

    def sigma(cl, cr):
        c2 = (torch.log(cl) - 2 * torch.log(cm) + torch.log(cr)) / 2.0
        return torch.where(c2 < 0, torch.sqrt(-1.0 / (2.0 * c2)), torch.nan)

    interior = pk.interior()
    sx = sigma(pk.at(-1, flat), pk.at(1, flat))
    sy = sigma(pk.at(-pk.k, flat), pk.at(pk.k, flat))
    return pk.out(torch.where(interior, sx, torch.nan), torch.where(interior, sy, torch.nan))


def uncertainty_map(frame_a, frame_b, wind_size: int, overlap: int,
                    exclusion_window: int = 3,
                    device="auto") -> Tuple[np.ndarray, np.ndarray]:
    """Per-vector sub-pixel uncertainty ``([R, C] sigma_u, [R, C]
    sigma_v)`` in pixels.

    First-order propagation of the correlation plane's noise floor through
    the 3-point log-Gaussian estimator: with ``u = col + N/D``, ``N = ln c_l
    - ln c_r``, ``D = 2 ln c_l + 2 ln c_r - 4 ln c_m``,

        sigma_u^2 = s^2 * [ ((D - 2N) / (c_l D^2))^2
                          + ((D + 2N) / (c_r D^2))^2
                          + ((4N)     / (c_m D^2))^2 ]

    where ``s`` is the plane's standard deviation outside the
    ``(2*exclusion_window+1)^2`` neighbourhood of the peak (the peak-ratio
    exclusion).  The floor holds the random-correlation background, which is
    correlated between neighbours, so the estimate is conservative.
    Windows whose peak sits on the map's border return NaN.
    """
    pk = _Peak(frame_a, frame_b, wind_size, overlap, device)
    flat = pk.flat + (EPS - pk.flat.amin(dim=-1, keepdim=True))
    cm = pk.at(0, flat)
    excl = exclusion_mask(pk.m, pk.k, pk.kd, exclusion_window)
    cnt = (~excl).sum(dim=-1).float()
    mean = flat.masked_fill(excl, 0.0).sum(dim=-1) / cnt
    var = (((flat - mean[:, None]) ** 2).masked_fill(excl, 0.0).sum(dim=-1)
           / torch.clamp(cnt - 1.0, min=1.0))
    s = torch.sqrt(var)

    def axis_sigma(cl, cr):
        L, R, M = torch.log(cl), torch.log(cr), torch.log(cm)
        N = L - R
        D = 2.0 * L + 2.0 * R - 4.0 * M
        D2 = D * D
        g2 = (((D - 2.0 * N) / (cl * D2)) ** 2
              + ((D + 2.0 * N) / (cr * D2)) ** 2
              + ((4.0 * N) / (cm * D2)) ** 2)
        return torch.where(D < 0, s * torch.sqrt(g2), torch.nan)

    interior = pk.interior()
    su = axis_sigma(pk.at(-1, flat), pk.at(1, flat))
    sv = axis_sigma(pk.at(-pk.k, flat), pk.at(pk.k, flat))
    return pk.out(torch.where(interior, su, torch.nan), torch.where(interior, sv, torch.nan))
