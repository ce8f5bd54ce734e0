"""FFT cross-correlation of window batches (counterpart of
``torchpiv_tpu/ops/correlate.py``).

The unfused chain always correlates in float32 through ``torch.fft`` (cuFFT
on the card); the TPU's matmul DFT has no counterpart here.  The pass-fusion
kernels (``kernels/corrfit.py``, ``kernels/fused_pass.py``) run their own FFT.
"""
from __future__ import annotations

import torch


def correlate_fft(
    images_a: torch.Tensor, images_b: torch.Tensor, dc_normalize: bool = False
) -> torch.Tensor:
    """Batched circular cross-correlation over the last two dims,
    ``fftshift(irfft2(conj(rfft2(a)) * rfft2(b)))``: the peak at the centre
    means zero displacement.

    ``dc_normalize`` folds the first pass's per-window mean normalisation
    into the spectrum product: correlation is bilinear, so
    ``corr(a/mean_a, b/mean_b) == corr(a, b) * w^4 / (A00 * B00)`` with
    ``A00 = sum(a)`` the DC coefficient.
    """
    fa = torch.fft.rfft2(images_a)
    fb = torch.fft.rfft2(images_b)
    prod = torch.conj(fa) * fb
    if dc_normalize:
        n2 = float(images_a.shape[-2] * images_a.shape[-1])
        dc = fa[..., :1, :1].real * fb[..., :1, :1].real
        prod = prod * (n2 * n2 / dc)
    corr = torch.fft.irfft2(prod, s=images_a.shape[-2:])
    return torch.fft.fftshift(corr, dim=(-2, -1))


def min_subtract(corr: torch.Tensor) -> torch.Tensor:
    """Shift each correlation map so its minimum is zero."""
    return corr - corr.amin(dim=(-2, -1), keepdim=True)
