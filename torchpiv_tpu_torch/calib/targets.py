"""Calibration-target detection: dot-grid images -> world/image points;
a copy of ``torchpiv_tpu/calib/targets.py``.

The standard stereo-PIV calibration input is a photograph of a regular
grid of dots at a known spacing, repeated at a few known out-of-plane
positions.  ``detect_dot_grid`` finds the dot centroids (intensity-
weighted, sub-pixel), orders them into grid rows/columns, and assigns
world coordinates centred on the grid, ready for ``CameraMapping.fit``.

Host-side numpy/scipy: calibration runs once per experiment, never in the
frame hot path.  Assumes the target is roughly axis-aligned in the image
(camera roll below ~20 deg) — the usual lab setup; oblique *viewing*
angles (the stereo rig's pan/tilt) are fine.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _otsu_threshold(img: np.ndarray) -> float:
    """Classic Otsu between-class-variance threshold on a 256-bin
    histogram (works for uint8 and normalised float input alike)."""
    lo, hi = float(img.min()), float(img.max())
    if hi <= lo:
        raise ValueError("constant image: no dots to detect")
    hist, edges = np.histogram(img, bins=256, range=(lo, hi))
    centers = 0.5 * (edges[:-1] + edges[1:])
    w = hist.astype(np.float64)
    p = w / w.sum()
    omega = np.cumsum(p)
    mu = np.cumsum(p * centers)
    mu_t = mu[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_b = (mu_t * omega - mu) ** 2 / (omega * (1.0 - omega))
    return float(centers[np.nanargmax(sigma_b)])


def detect_dots(
    image: np.ndarray,
    invert: bool = False,
    min_area: int = 4,
    max_area_frac: float = 0.01,
) -> np.ndarray:
    """Sub-pixel dot centroids ``[N, 2]`` as (X, Y) image coordinates.

    Otsu-thresholds the (optionally inverted) image, labels connected
    bright components, and returns intensity-weighted centroids of the
    components whose pixel area is in ``[min_area, max_area_frac*npix]``
    (rejects noise speckles and large glare blobs).  ``invert=True`` for
    the common dark-dots-on-white target.
    """
    from scipy import ndimage

    img = np.asarray(image, np.float64)
    if img.ndim != 2:
        raise ValueError("expected a 2-D grayscale image")
    if invert:
        img = img.max() - img
    thr = _otsu_threshold(img)
    mask = img > thr
    labels, n = ndimage.label(mask)
    if n == 0:
        raise ValueError("no dots found above the Otsu threshold")
    areas = ndimage.sum_labels(np.ones_like(img), labels, index=np.arange(1, n + 1))
    keep = np.nonzero(
        (areas >= min_area) & (areas <= max_area_frac * img.size))[0] + 1
    if keep.size == 0:
        raise ValueError(
            f"no dots in the admitted area range [{min_area}, "
            f"{max_area_frac:.2%} of frame] — {n} raw components")
    # intensity-weighted centroid above the threshold floor (sub-pixel)
    weight = np.clip(img - thr, 0.0, None)
    cy, cx = zip(*ndimage.center_of_mass(weight, labels, index=keep))
    return np.stack([np.asarray(cx), np.asarray(cy)], axis=1)


def order_into_grid(
    points: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Order detected centroids into grid (row, col) indices.

    Rows are found by sorting on image Y and splitting where the Y gap
    exceeds half the median nearest-neighbour dot distance; columns by
    sorting each row on X.  Returns ``(ij [N, 2] int, points [N, 2]
    reordered, (n_rows, n_cols))``; raises if rows are ragged (missed or
    spurious dots), which is the honest failure mode for calibration.
    """
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2 or len(pts) < 4:
        raise ValueError("need at least 4 detected dots, as [N, 2]")
    # robust dot-pitch estimate: median nearest-neighbour distance
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    pitch_px = float(np.median(np.sqrt(d2.min(axis=1))))
    order = np.argsort(pts[:, 1], kind="stable")
    ys = pts[order, 1]
    row_idx_sorted = np.concatenate(
        [[0], np.cumsum(np.diff(ys) > 0.5 * pitch_px)])
    row_of = np.zeros(len(pts), np.int64)
    row_of[order] = row_idx_sorted
    n_rows = int(row_of.max()) + 1
    counts = np.bincount(row_of, minlength=n_rows)
    if counts.min() != counts.max():
        raise ValueError(
            f"ragged dot grid: row sizes {sorted(set(counts.tolist()))} — "
            "missed/spurious dots; adjust min_area/invert or re-shoot")
    n_cols = int(counts[0])
    ij = np.empty((len(pts), 2), np.int64)
    out = np.empty_like(pts)
    pos = 0
    for r in range(n_rows):
        members = np.nonzero(row_of == r)[0]
        members = members[np.argsort(pts[members, 0], kind="stable")]
        for c, m in enumerate(members):
            ij[pos] = (r, c)
            out[pos] = pts[m]
            pos += 1
    return ij, out, (n_rows, n_cols)


def detect_dot_grid(
    image: np.ndarray,
    spacing: float,
    z: float = 0.0,
    invert: bool = False,
    min_area: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """One calibration image -> ``(world [N, 3], image [N, 2])`` for
    ``CameraMapping.fit``.

    ``spacing`` is the physical dot pitch (e.g. mm); world coordinates are
    centred on the grid, x increasing along image columns and y along
    image rows, and every point carries the plane height ``z``.  Stack the
    outputs from several planes for a stereo-capable fit.
    """
    centroids = detect_dots(image, invert=invert, min_area=min_area)
    ij, pts, (n_rows, n_cols) = order_into_grid(centroids)
    wx = (ij[:, 1] - (n_cols - 1) / 2.0) * spacing
    wy = (ij[:, 0] - (n_rows - 1) / 2.0) * spacing
    world = np.stack([wx, wy, np.full(len(pts), float(z))], axis=1)
    return world, pts
