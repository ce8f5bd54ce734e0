"""Correlation followed by the peak fit, per window pair: the plain PyTorch
versions of the pass-fusion kernels (``kernels/corrfit.py`` and
``kernels/fused_pass.py``; counterparts of ``correlate_peakfit_pallas`` and
``fused_piv_pass`` in ``torchpiv_tpu/experimental/fused_pass.py``).

The arithmetic follows the fused kernels, not the unfused chain:

* the correlation is ``fftshift(irfft2(conj(rfft2 a) * rfft2 b))`` through
  ``torch.fft`` (the CUDA kernels run a radix-2 FFT in shared memory);
* ``dc_normalize`` (pass 1, the per-window mean normalisation) scales the
  finished map by ``w**4 / (sum(a) * sum(b))``, where ``correlate_fft``
  folds the same factor into the spectrum product;
* the fit reads ``(x - min) + EPS``, where ``ops.peakfit`` with
  ``min_subtract`` reads ``x + (EPS - min)``.

The kernels and these versions sum in different orders, so they agree to a
tolerance (1e-4 px RMS on valid windows), not to the last bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .correlate import correlate_fft
from .peakfit import correlation_to_displacement
from .shifts import shift_windows_reference

MIN_WIND, MAX_WIND = 4, 128


def corrfit_supported(wind_size: int) -> bool:
    """Window sizes of the pass-fusion kernels: a power of two in 4..128
    (the JAX engine's rule for ``fused="split"``)."""
    w = wind_size
    return MIN_WIND <= w <= MAX_WIND and (w & (w - 1)) == 0


def correlate_peakfit_reference(
    windows_a: torch.Tensor,
    windows_b: torch.Tensor,
    validate: bool = True,
    val_ratio: float = 1.2,
    validation_window: int = 3,
    dc_normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``[N, w, w]`` float32 window pairs -> flat ``(u, v, invalid)``
    (``invalid`` is None without validation)."""
    a = windows_a.to(torch.float32)
    b = windows_b.to(torch.float32)
    w = a.shape[-1]
    x = correlate_fft(a, b)
    if dc_normalize:
        norm = float(w * w) ** 2 / (a.sum(dim=(-2, -1)) * b.sum(dim=(-2, -1)))
        x = x * norm[:, None, None]
    # the fit adds EPS to every sample it reads: (x - min) + EPS
    x = x - x.amin(dim=(-2, -1), keepdim=True)
    return correlation_to_displacement(x, validate, val_ratio, validation_window,
                                       min_subtract=False)


def fused_pass_reference(
    frame_a: torch.Tensor,
    frame_b: torch.Tensor,
    vxa: torch.Tensor,
    vya: torch.Tensor,
    vxb: torch.Tensor,
    vyb: torch.Tensor,
    *,
    frame_shape: Tuple[int, int],
    wind_size: int,
    overlap: int,
    validate: bool = True,
    val_ratio: float = 1.2,
    validation_window: int = 3,
    max_shift: Optional[int] = None,
    dc_normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """One whole pass on ``[B, H, W]`` frames and ``[B, N]`` per-window
    shifts of each frame: the bilinear window shift with flat-wrap edges,
    then ``correlate_peakfit_reference``.  Returns ``[B, N]`` fields."""
    kw = dict(frame_shape=frame_shape, wind_size=wind_size, overlap=overlap,
              max_shift=max_shift, flat_wrap=True)
    aa = shift_windows_reference(frame_a, vxa, vya, **kw)
    bb = shift_windows_reference(frame_b, vxb, vyb, **kw)
    shape = aa.shape[:2]
    w = wind_size
    u, v, inval = correlate_peakfit_reference(
        aa.reshape(-1, w, w), bb.reshape(-1, w, w), validate, val_ratio,
        validation_window, dc_normalize)
    return (u.reshape(shape), v.reshape(shape),
            None if inval is None else inval.reshape(shape))
