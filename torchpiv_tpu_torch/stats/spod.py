"""Spectral POD (SPOD) of time-resolved PIV field sequences;
a copy of ``torchpiv_tpu/stats/spod.py``.

Towne, Schmidt & Colonius, JFM 847 (2018): the frequency-domain form of
POD for statistically stationary flows — Welch-blocked windowed FFTs of
the fluctuation field, then at EACH frequency an eigendecomposition of
the cross-spectral density across blocks.  Where snapshot POD
(stats/pod.py) ranks structures by energy irrespective of dynamics, SPOD
modes are coherent structures evolving at a single frequency, each with
its own energy spectrum — the right decomposition for time-resolved PIV
of shedding/jet/screech-type flows.  No counterpart in the reference
(workers.py accumulates first/second moments only).

Host-side numpy like the other modal tools: the per-frequency SVDs are
``[n_blocks, 2RC]`` LAPACK calls, seconds at PIV scales.

Normalisation: eigenvalues integrate to the total fluctuation energy —
``sum_f sum_m lambda[f, m] == mean_t sum_xy (u'^2 + v'^2)`` (one-sided
spectrum, interior bins doubled; exact with the boxcar window and
non-overlapping blocks, Parseval — pinned in tests/test_spod.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class SPODResult:
    """Per-frequency energy-ranked SPOD.

    - ``freqs [F]``: one-sided frequency axis (Hz for ``fs`` in Hz).
    - ``energies [F, M]``: SPOD eigenvalues — energy of mode m at
      frequency f (descending in m at each f); summing over everything
      gives the total fluctuation energy.
    - ``modes_u/modes_v [F, M, R, C]`` (complex): spatial modes, unit
      2-norm over the stacked (u, v) state at each (f, m).
    - ``n_blocks``: Welch blocks actually used (statistical sample size
      per frequency; modes with m >= n_blocks do not exist).
    """

    freqs: np.ndarray
    energies: np.ndarray
    modes_u: np.ndarray
    modes_v: np.ndarray
    n_blocks: int

    def spectrum(self) -> np.ndarray:
        """Total energy per frequency (sum over modes), ``[F]``."""
        return self.energies.sum(axis=1)


def _default_nfft(n: int) -> int:
    """Largest power of two giving >= ~5 blocks at 50% overlap (Towne's
    guideline), floored at 8; the whole series when it is short."""
    if n < 16:
        return n
    nfft = 8
    while nfft * 2 <= n // 4:
        nfft *= 2
    return nfft


def compute_spod(
    u_stack: np.ndarray,
    v_stack: np.ndarray,
    fs: float = 1.0,
    n_fft: Optional[int] = None,
    overlap: float = 0.5,
    window: str = "hann",
    n_modes: Optional[int] = None,
    mask: Optional[np.ndarray] = None,
) -> SPODResult:
    """SPOD of ``[N, R, C]`` u/v sequences sampled at ``fs``.

    ``n_fft`` sets the block length (frequency resolution ``fs / n_fft``);
    ``overlap`` the Welch block overlap fraction; ``window`` "hann"
    (default, sidelobe suppression) or "boxcar" (exact Parseval).
    ``mask`` (``[R, C]`` or ``[N, R, C]``, True = invalid) and NaNs
    contribute zero fluctuation, as in :func:`stats.pod.compute_pod`.
    """
    u = np.asarray(u_stack, dtype=np.float64)
    v = np.asarray(v_stack, dtype=np.float64)
    if u.ndim != 3 or u.shape != v.shape:
        raise ValueError(
            f"expected matching [N,R,C] stacks, got {u.shape} / {v.shape}")
    if not 0.0 <= overlap < 1.0:
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    if n_modes is not None and n_modes < 1:
        raise ValueError(f"n_modes must be >= 1, got {n_modes}")
    n, r, c = u.shape
    nfft = _default_nfft(n) if n_fft is None else int(n_fft)
    if not 2 <= nfft <= n:
        raise ValueError(f"n_fft={nfft} out of range [2, {n}]")

    bad = ~np.isfinite(u) | ~np.isfinite(v)
    if mask is not None:
        bad |= np.broadcast_to(np.asarray(mask, dtype=bool), u.shape)
    cnt = np.maximum((~bad).sum(axis=0), 1)  # all-invalid points -> mean 0
    mean_u = np.where(bad, 0.0, u).sum(axis=0) / cnt
    mean_v = np.where(bad, 0.0, v).sum(axis=0) / cnt
    q = np.concatenate(
        [np.where(bad, 0.0, u - mean_u[None]).reshape(n, -1),
         np.where(bad, 0.0, v - mean_v[None]).reshape(n, -1)],
        axis=1,
    )  # [N, 2RC] fluctuation state

    if window == "hann":
        # periodic Hann (DFT-even), the spectral-analysis form
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / nfft)
    elif window == "boxcar":
        w = np.ones(nfft)
    else:
        raise ValueError(f"unknown window {window!r}")

    step = max(1, nfft - int(round(overlap * nfft)))
    starts = list(range(0, n - nfft + 1, step))
    n_blocks = len(starts)
    if n_blocks < 1:
        raise ValueError(f"series too short: {n} samples < n_fft={nfft}")

    # block FFTs, scaled so Parseval gives sum_f |qhat|^2 = the block's
    # window-weighted mean-square state (see module docstring)
    scale = 1.0 / np.sqrt(nfft * float((w**2).sum()))
    qhat = np.empty((n_blocks, nfft // 2 + 1, q.shape[1]), np.complex128)
    for b, s in enumerate(starts):
        qhat[b] = np.fft.rfft(w[:, None] * q[s:s + nfft], axis=0) * scale

    # one-sided doubling: rfft keeps f >= 0; interior bins carry the
    # energy of their negative twins too
    nf = nfft // 2 + 1
    fold = np.full(nf, 2.0)
    fold[0] = 1.0
    if nfft % 2 == 0:
        fold[-1] = 1.0

    m = n_blocks if n_modes is None else min(int(n_modes), n_blocks)
    energies = np.zeros((nf, m))
    modes = np.zeros((nf, m, q.shape[1]), np.complex128)
    for f in range(nf):
        x = qhat[:, f, :] / np.sqrt(n_blocks)  # CSD = x^H x
        _, s, vh = np.linalg.svd(x, full_matrices=False)
        k = min(m, s.size)
        energies[f, :k] = fold[f] * s[:k] ** 2
        modes[f, :k] = np.conj(vh[:k])
    freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
    return SPODResult(
        freqs=freqs,
        energies=energies,
        modes_u=modes[:, :, : r * c].reshape(nf, m, r, c),
        modes_v=modes[:, :, r * c:].reshape(nf, m, r, c),
        n_blocks=n_blocks,
    )
