"""Spatial energy spectra of velocity-fluctuation fields;
a copy of ``torchpiv_tpu/stats/spectra.py``.

Standard turbulence post-analysis on PIV grids (the quantity inertial-range
/ resolution arguments are made with; no reference counterpart — the
reference stops at single-point moments, workers.py:85-119): 1-D spatial
power spectral densities of u/v fluctuations along grid rows or columns,
Hann-windowed and averaged across the transverse axis and snapshots, with
Parseval-consistent normalisation so ``integral E(k) dk = variance``.

Host-side numpy on final [R, C] / [N, R, C] fields.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def spatial_spectrum(
    f: np.ndarray,
    dx: float,
    axis: int = -1,
    window: str = "hann",
    subtract_mean: bool = True,
    mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-sided spatial PSD of one field component; returns ``(k, psd)``.

    ``f`` is ``[R, C]`` or ``[N, R, C]``; the transform runs along ``axis``
    (the last two axes index the grid) and the PSD is averaged over every
    other axis.  ``k`` is in cycles per unit length of ``dx`` (e.g. 1/mm
    for ``dx`` in mm); ``psd`` integrates to the component's variance.
    Invalid vectors (``mask`` True or NaN) are replaced by the line mean
    (zero fluctuation) before transforming — fine for the few-percent
    outlier rates validation leaves behind, not for gappy fields.
    """
    f = np.asarray(f, dtype=np.float64)
    # resolve `axis` to a grid axis BEFORE promoting 2-D input, so that
    # axis=0 on an [N,R,C] stack (the snapshot axis) is rejected instead of
    # silently transforming the wrong dimension
    if f.ndim == 2:
        if axis in (0, -2):
            along_rows = True
        elif axis in (1, -1):
            along_rows = False
        else:
            raise ValueError("axis selects a GRID axis: -1/1 (cols) or "
                             "-2/0 (rows) for [R,C] input")
        f = f[None]
    elif f.ndim == 3:
        if axis in (1, -2):
            along_rows = True
        elif axis in (2, -1):
            along_rows = False
        else:
            raise ValueError("axis selects a GRID axis of the [N,R,C] "
                             "stack: -1/2 (cols) or -2/1 (rows)")
    else:
        raise ValueError(f"expected [R,C] or [N,R,C], got shape {f.shape}")
    if along_rows:
        f = np.swapaxes(f, -1, -2)
    bad = ~np.isfinite(f)
    if mask is not None:
        m = np.asarray(mask, dtype=bool)
        if m.ndim == 2:
            m = m[None]
        if along_rows:
            m = np.swapaxes(m, -1, -2)
        bad |= np.broadcast_to(m, f.shape)
    n = f.shape[-1]
    if n < 4:
        raise ValueError("need >= 4 points along the transform axis")
    fz = np.where(bad, np.nan, f)
    with np.errstate(invalid="ignore"):
        line_mean = np.nanmean(fz, axis=-1, keepdims=True)
    line_mean = np.nan_to_num(line_mean)
    fl = np.where(bad, line_mean, f)
    if subtract_mean:
        fl = fl - line_mean

    if window == "hann":
        w = np.hanning(n)
    elif window in (None, "boxcar", "none"):
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window {window!r}")
    w2 = float(np.mean(w * w))

    spec = np.fft.rfft(fl * w, axis=-1)
    # one-sided PSD, cycles-per-unit-length convention:
    #   sum(psd) * dk = variance, dk = 1/(n*dx)
    psd = (np.abs(spec) ** 2) * (2.0 * dx / (n * w2))
    psd[..., 0] /= 2.0
    if n % 2 == 0:
        psd[..., -1] /= 2.0
    k = np.fft.rfftfreq(n, d=dx)
    return k, psd.mean(axis=tuple(range(psd.ndim - 1)))


def energy_spectrum(
    u: np.ndarray,
    v: np.ndarray,
    dx: float,
    axis: int = -1,
    mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Total kinetic-energy spectrum ``E(k) = (PSD_u + PSD_v) / 2`` along
    one grid axis; returns ``(k, E)`` with ``integral E dk = tke`` (the
    2-component turbulent kinetic energy per unit mass).
    """
    k, pu = spatial_spectrum(u, dx, axis=axis, mask=mask)
    _, pv = spatial_spectrum(v, dx, axis=axis, mask=mask)
    return k, 0.5 * (pu + pv)
