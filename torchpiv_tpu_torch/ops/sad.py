"""Experimental SAD (sum of absolute differences) matchers (counterpart of
``torchpiv_tpu/ops/sad.py``).

The reference ships two matchers beside its FFT correlator that its
pipeline never calls: a separable "fast SAD" on row and column mean
profiles, and an FFT-domain SAD approximation by a cosine/sine Fourier
series.  They are part of its component surface, so the port carries them
as torch ops on window batches (the FFT through ``torch.fft``), for
research; the multipass engine does not use them.  A blank window
normalises to 0/0 = NaN, as in the JAX package.
"""
from __future__ import annotations

import torch


def batch_normalize(windows: torch.Tensor) -> torch.Tensor:
    """Per-window min-max normalisation to [0, 1] (reference
    ``batchNormalize``)."""
    w = windows.float()
    w = w - w.amin(dim=(-2, -1), keepdim=True)
    return w / w.amax(dim=(-2, -1), keepdim=True)


def _profile_sad(pa: torch.Tensor, pb: torch.Tensor, size: int) -> torch.Tensor:
    """SAD between ``pb`` ``[N, size]`` and every placement of ``pa`` in a
    zero-padded strip of ``2 * size`` -> ``[N, size + 1]``."""
    strip = pa.new_zeros(pa.shape[0], 2 * size)
    strip[:, size // 2:size // 2 + size] = pa
    windows = strip.unfold(1, size, 1)  # [N, size + 1, size]
    return (pb[:, None, :] - windows).abs().sum(dim=-1)


def fast_sad(images_a: torch.Tensor, images_b: torch.Tensor):
    """Separable SAD on column-mean and row-mean profiles (reference
    ``fastSAD``) of ``[N, m, n]`` windows -> ``(sad_x [N, n + 1], sad_y
    [N, m + 1])``: the SAD curve over the sliding placements, whose
    minimum locates the integer displacement."""
    a = batch_normalize(images_a)
    b = batch_normalize(images_b)
    n, m = a.shape[-1], a.shape[-2]
    return (_profile_sad(a.mean(dim=-2), b.mean(dim=-2), n),
            _profile_sad(a.mean(dim=-1), b.mean(dim=-1), m))


def sad_fft(images_a: torch.Tensor, images_b: torch.Tensor, p: int = 5) -> torch.Tensor:
    """FFT-domain SAD approximation (reference ``sadFFTReal``): ``|x - y|``
    expands in odd harmonics of cosine and sine cross terms, each a circular
    correlation in the spectral domain.  Returns the fftshifted map
    ``[N, h, w]`` whose minimum locates the displacement."""
    a = batch_normalize(images_a)
    b = batch_normalize(images_b)
    acc = None
    for i in range(1, p + 1):
        base = 2 * i - 1
        sa = a * base
        sb = b * base
        term = (torch.conj(torch.fft.rfft2(torch.cos(sa))) * torch.fft.rfft2(torch.cos(sb))
                + torch.conj(torch.fft.rfft2(torch.sin(sa))) * torch.fft.rfft2(torch.sin(sb))
                ) / base**2
        acc = term if acc is None else acc + term
    out = torch.fft.irfft2(acc, s=a.shape[-2:])
    return torch.fft.fftshift(out, dim=(-2, -1))
