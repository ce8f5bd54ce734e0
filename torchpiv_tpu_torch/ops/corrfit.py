"""Correlation followed by the peak fit, per window pair: the plain PyTorch
versions of the pass-fusion kernels (``kernels/corrfit.py`` and
``kernels/fused_pass.py``; counterparts of ``correlate_peakfit_pallas`` and
``fused_piv_pass`` in ``torchpiv_tpu/experimental/fused_pass.py``).

The arithmetic follows the fused kernels, not the unfused chain:

* the correlation is ``fftshift(irfft2(conj(rfft2 a) * rfft2 b))`` through
  ``torch.fft`` (the CUDA kernels run their own FFT in registers and shared
  memory, ``csrc/corrfit.cuh``; ``correlate_fit_steps`` walks its steps);
* ``dc_normalize`` (pass 1, the per-window mean normalisation) scales the
  finished map by ``w**4 / (sum(a) * sum(b))``, where ``correlate_fft``
  folds the same factor into the spectrum product;
* the fit reads ``(x - min) + EPS``, where ``ops.peakfit`` with
  ``min_subtract`` reads ``x + (EPS - min)``.

The kernels and these versions sum in different orders, so they agree to a
tolerance (1e-4 px RMS on valid windows), not to the last bit.
"""
from __future__ import annotations

import math
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


def twiddle_table(wind_size: int) -> torch.Tensor:
    """``[w/2, 2]`` float32 table ``(cos, -sin)(2*pi*j/w)`` on the CPU,
    computed in float64 and rounded once."""
    ang = [2.0 * math.pi * j / wind_size for j in range(wind_size // 2)]
    table = torch.tensor([[math.cos(a), -math.sin(a)] for a in ang],
                         dtype=torch.float64)
    return table.to(torch.float32)


# W = P * L of ``Plan<W>`` in csrc/corrfit.cuh: the radix of the step on P
# strided samples of a line and of the step on L neighbouring ones.
PLANS = {4: (4, 1), 8: (8, 1), 16: (16, 1), 32: (32, 1), 64: (8, 8), 128: (16, 8)}


def _bit_reverse(x: int, n: int) -> int:
    r, b = 0, 1
    while b < n:
        r, x, b = (r << 1) | (x & 1), x >> 1, b << 1
    return r


def _fft_registers(x: list, w: int, tw: torch.Tensor, inverse: bool) -> None:
    """``fft_registers`` of the kernel on the list ``x`` of ``n`` complex
    tensors: radix-2 decimation in frequency, ``x[q]`` ends as frequency
    ``bit_reverse(q)``; ``tw[t]`` is ``exp(-2 pi i t / w)``."""
    n = len(x)
    half = n // 2
    while half >= 1:
        for b in range(n // 2):
            j = b & (half - 1)
            i0 = ((b - j) << 1) + j
            i1 = i0 + half
            t = j * (n // (2 * half)) * (w // n)
            p, q = x[i0], x[i1]
            x[i0] = p + q
            d = p - q
            if t:
                d = d * (tw[t].conj() if inverse else tw[t])
            x[i1] = d
        half //= 2


def _fft_step(z: torch.Tensor, w: int, radix: int, stride: int, inverse: bool,
              rows: bool, twiddle: bool, tw: torch.Tensor) -> None:
    """``fft_step`` of the kernel, in place on the storage ``z [N, w, w]``."""
    lines = z if rows else z.transpose(-1, -2)  # [N, line, position]
    for sub in range(w // radix):
        pos = [radix * sub + j if stride == 1 else stride * j + sub
               for j in range(radix)]
        x = [lines[..., p].clone() for p in pos]
        _fft_registers(x, w, tw, inverse)
        for q in range(radix):
            k = _bit_reverse(q, radix)
            val = x[q]
            if twiddle and k:
                f = tw[sub * k]
                val = val * (f.conj() if inverse else f)
            lines[..., pos[k]] = val


def _fft_axis(z, w, inverse, rows, tw) -> None:
    P, L = PLANS[w]
    if not inverse:
        _fft_step(z, w, P, L, False, rows, L > 1, tw)
        if L > 1:
            _fft_step(z, w, L, 1, False, rows, False, tw)
    else:
        if L > 1:
            _fft_step(z, w, L, 1, True, rows, True, tw)
        _fft_step(z, w, P, L, True, rows, False, tw)


def correlate_fit_steps(
    windows_a: torch.Tensor,
    windows_b: torch.Tensor,
    validate: bool = True,
    val_ratio: float = 1.2,
    validation_window: int = 3,
    dc_normalize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``correlate_peakfit_reference`` by the steps of the CUDA kernels'
    ``correlate_fit`` (``csrc/corrfit.cuh``), with tensor ops in float32:
    one complex array ``a + i b``, the split-line transforms in place (the
    spectrum in digit-reversed order), the Hermitian product through the
    position of the opposite frequency with the ``fftshift`` sign and the
    ``1 / w**2`` folded in, the inverse steps, the scaling of the finished
    map.  A model of the kernel's index arithmetic for the CPU tests: no
    path of the package calls it."""
    w = windows_a.shape[-1]
    P, L = PLANS[w]
    half = torch.view_as_complex(twiddle_table(w).contiguous())
    tw = torch.cat([half, -half])  # exp(-2 pi i j / w), j < w
    z = torch.complex(windows_a.to(torch.float32), windows_b.to(torch.float32))
    _fft_axis(z, w, False, True, tw)
    _fft_axis(z, w, False, False, tw)
    sums = z[:, 0, 0].clone()

    pos = torch.arange(w)
    freq = pos // L + P * (pos % L)  # the frequency stored at a position
    neg = (w - freq) & (w - 1)
    opposite = L * (neg % P) + neg // P
    parity = (pos // L) & 1
    zn = z[:, opposite][:, :, opposite]
    a_r, a_i = 0.5 * (z.real + zn.real), 0.5 * (z.imag - zn.imag)
    b_r, b_i = 0.5 * (z.imag + zn.imag), -0.5 * (z.real - zn.real)
    sg = torch.where(((parity[:, None] + parity[None, :]) & 1).bool(), -1.0, 1.0)
    sg = (sg / float(w * w)).to(torch.float32)
    z = torch.complex((a_r * b_r + a_i * b_i) * sg, (a_r * b_i - a_i * b_r) * sg)

    _fft_axis(z, w, True, False, tw)
    _fft_axis(z, w, True, True, tw)
    x = z.real
    if dc_normalize:
        norm = float(w * w) ** 2 / (sums.real * sums.imag)
        x = x * norm[:, None, None]
    x = x - x.amin(dim=(-2, -1), keepdim=True)
    return correlation_to_displacement(x, validate, val_ratio, validation_window,
                                       min_subtract=False)


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
