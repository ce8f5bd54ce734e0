"""FFT cross-correlation of window batches (counterpart of
``torchpiv_tpu/ops/correlate.py``).

The unfused chain always correlates in float32 through ``torch.fft`` (cuFFT
on the card); the TPU's matmul DFT has no counterpart here.  The pass-fusion
kernels (``kernels/corrfit.py``, ``kernels/fused_pass.py``) run their own FFT.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch


def correlate_fft(
    images_a: torch.Tensor, images_b: torch.Tensor, dc_normalize: bool = False,
    phase_filter: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched circular cross-correlation over the last two dims,
    ``fftshift(irfft2(conj(rfft2(a)) * rfft2(b)))``: the peak at the centre
    means zero displacement.

    ``dc_normalize`` folds the first pass's per-window mean normalisation
    into the spectrum product: correlation is bilinear, so
    ``corr(a/mean_a, b/mean_b) == corr(a, b) * w^4 / (A00 * B00)`` with
    ``A00 = sum(a)`` the DC coefficient.

    ``phase_filter`` (``rpc_filter``) switches to robust phase correlation:
    the cross-spectrum is normalised to unit magnitude per frequency bin and
    weighted by the filter; it takes precedence over ``dc_normalize``, which
    a phase-only spectrum makes meaningless.

    Windows of a lower precision (``dtype="bfloat16"`` or ``"float16"``)
    are promoted to float32 first, as the JAX package's matmul DFT does.
    """
    images_a, images_b = images_a.float(), images_b.float()
    fa = torch.fft.rfft2(images_a)
    fb = torch.fft.rfft2(images_b)
    prod = torch.conj(fa) * fb
    if phase_filter is not None:
        prod = _phase_normalize(prod) * phase_filter
    elif dc_normalize:
        n2 = float(images_a.shape[-2] * images_a.shape[-1])
        dc = fa[..., :1, :1].real * fb[..., :1, :1].real
        prod = prod * (n2 * n2 / dc)
    corr = torch.fft.irfft2(prod, s=images_a.shape[-2:])
    return torch.fft.fftshift(corr, dim=(-2, -1))


def _phase_normalize(prod: torch.Tensor) -> torch.Tensor:
    """Cross-spectrum -> unit-magnitude phasors.  The guard epsilon is
    relative to each window's mean spectral magnitude, and bins that are
    structurally zero stay zero."""
    mag = prod.abs()
    eps = 1e-8 * mag.mean(dim=(-2, -1), keepdim=True) + 1e-30
    return prod / (mag + eps)


@lru_cache(maxsize=8)
def _rpc_filter_np(n: int, diameter: float) -> np.ndarray:
    """``[n, n // 2 + 1]`` spectral energy filter of an ideal Gaussian
    particle image ``exp(-8 r^2 / d^2)`` of diameter ``diameter`` px, whose
    energy spectrum is ``exp(-omega^2 d^2 / 16)`` with ``omega = 2 pi k /
    n`` (rows in natural DFT order, columns the rfft half spectrum); copied
    from ``torchpiv_tpu/ops/correlate.py``."""
    k_row = ((np.arange(n) + n // 2) % n) - n // 2  # signed frequencies
    k_col = np.arange(n // 2 + 1)
    k2 = (k_row.astype(np.float64) ** 2)[:, None] + \
        (k_col.astype(np.float64) ** 2)[None, :]
    w = np.exp(-(np.pi * diameter / n) ** 2 / 4.0 * k2)
    return w.astype(np.float32)


def rpc_filter(n: int, diameter: float = 2.8) -> torch.Tensor:
    """The RPC spectral filter (Eckstein & Vlachos 2008) as a tensor."""
    return torch.from_numpy(_rpc_filter_np(n, float(diameter)))


def mean_normalize(windows: torch.Tensor) -> torch.Tensor:
    """Divide each float32 window by its own mean intensity (the first
    pass's normalisation, written out where ``dc_normalize`` cannot fold
    it)."""
    return windows / windows.mean(dim=(-2, -1), keepdim=True)


def min_subtract(corr: torch.Tensor) -> torch.Tensor:
    """Shift each correlation map so its minimum is zero."""
    return corr - corr.amin(dim=(-2, -1), keepdim=True)
