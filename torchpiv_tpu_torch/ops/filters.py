"""Separable image filters in full float32 (counterpart of
``torchpiv_tpu/ops/filters.py``).

One blur serves every sub-pixel-sensitive smoothing of the package: the
particle detector's matched filter and the dense Lucas-Kanade solver's
anti-alias and solve smoothing.  A TF32 convolution in front of a 3-point
Gaussian fit or of the Lucas-Kanade gradients biases sub-pixel positions,
so on a CUDA device the blur raises unless TF32 is off (``check_no_tf32``),
as the JAX package forces ``precision="highest"``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.device import check_no_tf32


def gaussian_taps(sigma: float, truncate: float = 3.0,
                  device="cpu") -> torch.Tensor:
    """The normalised float32 ``2r + 1`` taps, ``r = max(1, ceil(truncate *
    sigma))``, in the JAX package's float32 operations, made on ``device``
    (no copy from the host, which would wait for the card)."""
    r = max(1, int(math.ceil(truncate * sigma)))
    span = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(span**2) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(x: torch.Tensor, sigma: float,
                  truncate: float = 3.0) -> torch.Tensor:
    """Separable "SAME" Gaussian blur of ``[H, W]`` or ``[B, H, W]`` float
    frames with zero padding: a row pass, then a column pass, each a 1-D
    convolution with the ``2r + 1`` taps of ``gaussian_taps``."""
    check_no_tf32(x.device)
    k = gaussian_taps(sigma, truncate, x.device)
    r = k.numel() // 2
    y = x.reshape(-1, 1, *x.shape[-2:]).float()
    y = F.conv2d(y, k.reshape(1, 1, 1, -1), padding=(0, r))
    y = F.conv2d(y, k.reshape(1, 1, -1, 1), padding=(r, 0))
    return y.reshape(x.shape)
