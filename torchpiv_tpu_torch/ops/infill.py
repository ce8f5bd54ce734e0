"""Host infill of invalid vectors (numpy/scipy).

Copy of the host part of ``torchpiv_tpu/ops/infill.py``
(``interpolate_borders`` and ``fill_missing_values``): 1-D linear infill
along the field borders, then Delaunay-linear interpolation fitted on the
valid pixels bordering the holes, aborting when more than half the field is
invalid.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

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
