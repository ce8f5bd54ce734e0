"""Infill of invalid vectors (counterpart of ``torchpiv_tpu/ops/infill.py``).

* Host (numpy/scipy), copied from that file: ``interpolate_borders`` and
  ``fill_missing_values``, 1-D linear infill along the field borders, then
  Delaunay-linear interpolation fitted on the valid pixels bordering the
  holes, aborting when more than half the field is invalid.
* On the device: ``fused_infill``, a masked 4-neighbour Jacobi relaxation
  that converges to the discrete Laplace interpolant of the holes.  It
  differs from the Delaunay interpolation at the 1e-2 level on the filled
  (already invalid) vectors, which is why the host version is the default.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


def interpolate_borders(vec: np.ndarray) -> np.ndarray:
    """1-D linear infill of NaNs along the four field borders (in place);
    a border that is entirely NaN is left untouched."""
    if not np.isnan(vec).any():
        return vec
    for row in (vec[0, :], vec[-1, :]):
        nans = np.isnan(row)
        if not nans.all():
            row[nans] = np.interp(np.nonzero(nans)[0], np.nonzero(~nans)[0], row[~nans])
    for col in (vec[:, 0], vec[:, -1]):
        nans = np.isnan(col)
        if not nans.all():
            col[nans] = np.interp(np.nonzero(nans)[0], np.nonzero(~nans)[0], col[~nans])
    return vec


def fill_missing_values(field: np.ndarray) -> Optional[np.ndarray]:
    """Delaunay-linear infill of NaN holes (in place); ``None`` if more than
    half the field is invalid.

    The abort test keeps the reference's quirk: ``points.size`` counts
    coordinates (twice the point count) against half the field.
    """
    from scipy import ndimage
    from scipy.interpolate import LinearNDInterpolator

    invalid = np.isnan(field)
    if not invalid.any():
        return field
    dilated = ndimage.binary_dilation(invalid, structure=_CROSS)
    border = dilated & ~invalid

    points = np.argwhere(border)
    values = field[border]
    if points.size < border.size / 2:
        try:
            interp = LinearNDInterpolator(points, values)
            field[invalid] = interp(np.argwhere(invalid))
        except Exception:
            return None
    else:
        return None
    return field


def fused_infill(field: torch.Tensor, invalid: torch.Tensor,
                 iters: Optional[int] = None) -> torch.Tensor:
    """Hole fill on the device: ``field`` ``[..., R, C]`` values, ``invalid``
    a bool mask of holes.  Valid values are held fixed; holes relax to the
    harmonic interpolant, seeded by a zero-order sweep, in ``iters`` Jacobi
    sweeps (default ``R + C``: enough for information to cross the field)."""
    rows, cols = field.shape[-2:]
    if iters is None:
        iters = rows + cols

    valid = ~invalid
    f = torch.where(valid, field, 0.0)
    pad = torch.nn.functional.pad

    def shift4_sum(x):
        # up + down + left + right neighbours, zero-padded at the edges, in
        # the JAX function's order of summation
        up = pad(x, (0, 0, 1, 0))[..., :-1, :]
        down = pad(x, (0, 0, 0, 1))[..., 1:, :]
        left = pad(x, (1, 0))[..., :, :-1]
        right = pad(x, (0, 1))[..., :, 1:]
        return ((up + down) + left) + right

    x, m = f, valid.to(field.dtype)
    for _ in range(iters):
        s = shift4_sum(x * m)
        c = shift4_sum(m)
        avg = s / torch.clamp(c, min=1.0)
        upd = invalid & (c > 0.0)
        x = torch.where(valid, f, torch.where(upd, avg, x))
        m = torch.where(valid | upd, 1.0, m)
    return torch.where(valid, field, x)
