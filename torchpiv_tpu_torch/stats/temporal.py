"""Temporal analysis for time-resolved PIV sequences (beyond the
reference, which only accumulates ensemble means — workers.py PIVWorker);
a copy of ``torchpiv_tpu/stats/temporal.py``.

Operates on a snapshot stack ``u/v [T, R, C]`` as produced by loading the
per-pair ``.npy`` binaries (``tpiv run --save 'Save all binary'``): probe
time series, Welch power spectral densities, temporal autocorrelation and
the integral time scale, and running-mean convergence — the standard
checks that a time-resolved run is long enough and resolves the dynamics.

Host-side numpy: these run once over the (small) final vector fields.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def probe_series(
    u: np.ndarray,
    v: np.ndarray,
    points: Sequence[Tuple[int, int]],
) -> Dict[str, np.ndarray]:
    """Extract ``[T, n_points]`` velocity time series at grid points.

    ``points`` are (row, col) vector-grid indices (negative indices OK).
    Returns ``{"u", "v"}``; NaN snapshots (invalid vectors) pass through.
    """
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError("expected matching [T, R, C] stacks")
    rows = np.asarray([p[0] for p in points], np.int64)
    cols = np.asarray([p[1] for p in points], np.int64)
    return {"u": u[:, rows, cols], "v": v[:, rows, cols]}


def welch_psd(
    series: np.ndarray,
    fs: float = 1.0,
    nperseg: Optional[int] = None,
    overlap: float = 0.5,
    detrend: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Welch-averaged one-sided PSD of ``[T]`` or ``[T, P]`` series.

    Hann-windowed overlapping segments, mean removed per segment when
    ``detrend``; normalised so that ``sum(psd) * df`` equals the series
    variance (Parseval, window-power corrected).  Returns
    ``(freqs [F], psd [F] or [F, P])`` with ``F = nperseg//2 + 1``.
    NaNs in a segment drop that segment (per column).
    """
    x = np.asarray(series, np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    T = x.shape[0]
    if nperseg is None:
        nperseg = min(256, T)
    nperseg = int(min(nperseg, T))
    if nperseg < 8:
        raise ValueError(f"series too short for a PSD: T={T}")
    step = max(1, int(round(nperseg * (1.0 - overlap))))
    win = np.hanning(nperseg)
    wpow = (win**2).sum()
    starts = range(0, T - nperseg + 1, step)
    freqs = np.fft.rfftfreq(nperseg, d=1.0 / fs)
    acc = np.zeros((len(freqs), x.shape[1]))
    cnt = np.zeros(x.shape[1])
    for s in starts:
        seg = x[s:s + nperseg]
        ok = np.isfinite(seg).all(axis=0)
        if not ok.any():
            continue
        seg = np.where(np.isfinite(seg), seg, 0.0)
        if detrend:
            seg = seg - seg.mean(axis=0, keepdims=True)
        spec = np.abs(np.fft.rfft(seg * win[:, None], axis=0)) ** 2
        # one-sided doubling (not DC; not Nyquist when nperseg even)
        spec[1:] *= 2.0
        if nperseg % 2 == 0:
            spec[-1] /= 2.0
        acc[:, ok] += spec[:, ok] / (fs * wpow)
        cnt += ok
    if not cnt.any():
        raise ValueError("every segment contained NaNs — nothing to average")
    psd = acc / np.maximum(cnt, 1)
    psd[:, cnt == 0] = np.nan
    return freqs, psd[:, 0] if squeeze else psd


def autocorrelation(series: np.ndarray, max_lag: Optional[int] = None
                    ) -> np.ndarray:
    """Biased temporal autocorrelation of a ``[T]`` or ``[T, P]`` series
    about its mean, ``rho[0] == 1``; lags ``0..max_lag`` (default T//2).
    NaNs are mean-filled (acceptable for the few-percent invalid-vector
    rates PIV produces)."""
    x = np.asarray(series, np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    T = x.shape[0]
    if max_lag is None:
        max_lag = T // 2
    max_lag = int(min(max_lag, T - 1))
    mu = np.nanmean(x, axis=0)
    x = np.where(np.isfinite(x), x, mu) - mu
    # FFT-based ACF (biased estimator: 1/T normalisation, standard in
    # turbulence practice — monotone-decreasing envelope)
    n = int(2 ** np.ceil(np.log2(2 * T)))
    f = np.fft.rfft(x, n=n, axis=0)
    acf = np.fft.irfft(f * np.conj(f), n=n, axis=0)[: max_lag + 1]
    var = acf[0].copy()
    var[var == 0] = np.nan
    rho = acf / var
    return rho[:, 0] if squeeze else rho


def integral_time_scale(series: np.ndarray, fs: float = 1.0) -> np.ndarray:
    """Integral time scale by trapezoidal integration of the ACF up to its
    first zero crossing (the standard turbulence estimator; avoids the
    noisy tail).  Returns a scalar for 1-D input, ``[P]`` otherwise."""
    rho = autocorrelation(series)
    if rho.ndim == 1:
        rho = rho[:, None]
        squeeze = True
    else:
        squeeze = False
    out = np.empty(rho.shape[1])
    for p in range(rho.shape[1]):
        r = rho[:, p]
        if not np.isfinite(r[0]):
            out[p] = 0.0  # zero-variance series: no correlation time
            continue
        neg = np.nonzero(r <= 0)[0]
        end = int(neg[0]) if neg.size else len(r)
        # np.trapezoid is numpy>=2 only; fall back on 1.x's np.trapz
        trap = getattr(np, "trapezoid", None) or np.trapz
        out[p] = trap(r[:end]) / fs if end > 1 else 0.5 / fs
    return float(out[0]) if squeeze else out


def running_mean(series: np.ndarray) -> np.ndarray:
    """Cumulative mean over time (NaN-skipping) — plot it to judge
    statistical convergence of a run."""
    x = np.asarray(series, np.float64)
    ok = np.isfinite(x)
    csum = np.cumsum(np.where(ok, x, 0.0), axis=0)
    cnt = np.cumsum(ok, axis=0).astype(np.float64)
    cnt[cnt == 0] = np.nan
    return csum / cnt


def convergence_report(
    u: np.ndarray,
    v: np.ndarray,
    fs: float = 1.0,
) -> Dict[str, float]:
    """Run-length adequacy summary for a time-resolved stack.

    Uses the spatial-median point series to estimate the integral time
    scale and reports the number of independent samples
    ``N_eff = T / (2 * T_int * fs)`` plus the relative standard error of
    the mean velocity magnitude — the quantities that decide whether the
    run is long enough.
    """
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    su = np.nanmedian(u, axis=(1, 2))
    sv = np.nanmedian(v, axis=(1, 2))
    T = len(su)
    t_int = max(float(integral_time_scale(su, fs)),
                float(integral_time_scale(sv, fs)))
    n_eff = T / max(2.0 * t_int * fs, 1.0)
    mag = np.hypot(su, sv)
    mean = float(np.nanmean(mag))
    sem = float(np.nanstd(mag) / np.sqrt(max(n_eff, 1.0)))
    return {
        "snapshots": float(T),
        "integral_time_scale_s": t_int,
        "effective_samples": float(n_eff),
        "mean_speed": mean,
        "relative_sem": sem / mean if mean else np.nan,
    }


def load_pair_stack(folder: str, min_snapshots: int = 2
                    ) -> Dict[str, np.ndarray]:
    """Load a folder of ``[4, R, C]`` per-pair ``.npy`` binaries (as
    written by ``--save 'Save all binary'``) into ``{"x", "y",
    "u" [T,R,C], "v" [T,R,C]}`` in acquisition order (the runner's
    uniquified ``name.npy, name (1).npy, ...`` series sorts with the
    bare name FIRST — see ``saved_series_key``)."""
    import glob
    import os

    from ..utils.persistence import saved_series_key

    files = sorted(glob.glob(os.path.join(folder, "*.npy")),
                   key=saved_series_key)
    us, vs = [], []
    x = y = None
    shape = None
    for f in files:
        arr = np.load(f)
        if arr.ndim != 3 or arr.shape[0] != 4:
            continue
        if shape is not None and arr.shape[1:] != shape:
            continue
        shape = arr.shape[1:]
        x, y = arr[0], arr[1]
        us.append(arr[2])
        vs.append(arr[3])
    if len(us) < min_snapshots:
        raise ValueError(f"{folder}: need >= {min_snapshots} saved "
                         f"[4, R, C] pair files")
    return {"x": x, "y": y, "u": np.stack(us), "v": np.stack(vs)}


def phase_from_probe(series: np.ndarray) -> np.ndarray:
    """Instantaneous phase [rad, 0..2pi) of a (mean-removed) probe signal
    via the analytic signal (Hilbert transform) — the standard reference
    for phase-locking PIV snapshots to a periodic process (vortex
    shedding, pulsatile flow) without an external trigger."""
    from scipy.signal import hilbert

    s = np.asarray(series, dtype=np.float64).ravel()
    if s.size < 4:
        raise ValueError("need >= 4 samples for a phase estimate")
    s = np.nan_to_num(s - np.nanmean(s))
    return np.angle(hilbert(s)) % (2 * np.pi)


def phase_average(
    u: np.ndarray,
    v: np.ndarray,
    phase: np.ndarray,
    n_bins: int = 8,
):
    """Phase-conditioned ensemble averaging of a snapshot stack.

    ``phase``: [T] radians per snapshot (e.g. :func:`phase_from_probe`,
    or ``2*pi*f*t % 2*pi`` for a known frequency).  Snapshots are binned
    into ``n_bins`` equal phase intervals and averaged per bin (NaNs
    excluded pointwise).  Returns ``(centers [n_bins], u_avg, v_avg
    [n_bins, R, C], counts [n_bins])`` — bins with no snapshots are NaN.
    The coherent (phase-locked) motion survives; turbulence and noise
    average out as 1/sqrt(count).
    """
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    phase = np.asarray(phase, dtype=np.float64).ravel()
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError("expected matching [T, R, C] stacks")
    if phase.size != u.shape[0]:
        raise ValueError(f"phase length {phase.size} != {u.shape[0]} "
                         f"snapshots")
    if n_bins < 1:
        raise ValueError("n_bins must be >= 1")
    idx = np.minimum((phase % (2 * np.pi)) / (2 * np.pi) * n_bins,
                     n_bins - 1).astype(np.int64)
    shape = (n_bins,) + u.shape[1:]
    ua = np.full(shape, np.nan)
    va = np.full(shape, np.nan)
    counts = np.zeros(n_bins, dtype=np.int64)
    with np.errstate(invalid="ignore"):
        for b in range(n_bins):
            sel = idx == b
            counts[b] = int(sel.sum())
            if counts[b]:
                ua[b] = np.nanmean(u[sel], axis=0)
                va[b] = np.nanmean(v[sel], axis=0)
    centers = (np.arange(n_bins) + 0.5) * 2 * np.pi / n_bins
    return centers, ua, va, counts
