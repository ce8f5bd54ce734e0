"""Two-camera stereo reconstruction of three-component displacement;
a copy of ``torchpiv_tpu/calib/stereo.py``.

Standard Soloff-style stereo PIV: each camera observes an in-plane pixel
displacement field of the SAME world grid; linearising each camera's
mapping around the measurement plane gives two equations per camera,

    (du_px, dv_px)_cam = J_cam @ (dx, dy, dz),        J_cam = d(image)/d(world),

and the four equations are solved per grid point in least squares for the
three world displacement components.  The condition of the stacked system
reflects the stereo angle (cameras viewing from the same direction cannot
resolve dz — ``stereo_reconstruct`` reports that via the residual).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .mapping import CameraMapping


def stereo_reconstruct(
    cam1: CameraMapping,
    cam2: CameraMapping,
    x_world: np.ndarray,
    y_world: np.ndarray,
    uv1_px: Tuple[np.ndarray, np.ndarray],
    uv2_px: Tuple[np.ndarray, np.ndarray],
    z: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-point least-squares 3C displacement from two camera fields.

    Args:
      cam1, cam2: fitted ``CameraMapping`` for each camera (MUST be
        calibrated with multiple z planes, otherwise dz is unobservable).
      x_world, y_world: the common analysis grid in world units — run both
        cameras' PIV on DEWARPED frames or map the vectors to this grid
        first.
      uv1_px, uv2_px: each camera's pixel displacement fields on that grid.

    Returns ``(dx, dy, dz, residual)`` in world units; ``residual`` is the
    per-point RMS of the 4-equation system (a data-quality map).
    """
    u1, v1 = (np.asarray(a, np.float64) for a in uv1_px)
    u2, v2 = (np.asarray(a, np.float64) for a in uv2_px)
    J1 = cam1.jacobian(x_world, y_world, z)  # [..., 2, 3]
    J2 = cam2.jacobian(x_world, y_world, z)
    A = np.concatenate([J1, J2], axis=-2)  # [..., 4, 3]
    b = np.stack([u1, v1, u2, v2], axis=-1)[..., None]  # [..., 4, 1]

    # batched least squares via normal equations (4x3 systems; the stereo
    # angle keeps them well-conditioned in practice)
    At = np.swapaxes(A, -1, -2)
    sol = np.linalg.solve(At @ A, At @ b)  # [..., 3, 1]
    resid = A @ sol - b
    rms = np.sqrt(np.mean(resid[..., 0] ** 2, axis=-1))
    d = sol[..., 0]
    return d[..., 0], d[..., 1], d[..., 2], rms


def table_to_px_field(table: Dict[str, np.ndarray], scale: float = 1.0,
                      dt: float = 1.0) -> Dict[str, np.ndarray]:
    """Undo the engine's physical-units conversion on a saved pair table.

    ``finalize_fields`` (pipeline.py) flips the velocity rows to a y-up
    physical axis, negates v, and converts px -> mm and px/frame -> m/s
    with the run's ``scale``/``dt``; stereo reconstruction needs the raw
    image-convention pixel displacements back.  Pass the SAME scale/dt the
    run used (defaults match ``--scale 1 --dt 1``).
    """
    cols = list(table)
    x, y, u, v = (np.asarray(table[c], np.float64) for c in cols[:4])
    return {
        "x": x / scale,
        "y": y / scale,
        "u": np.flip(u, axis=0) * dt / (scale * 1000.0),
        "v": -np.flip(v, axis=0) * dt / (scale * 1000.0),
    }


def _px_field_sampler(x_px: np.ndarray, y_px: np.ndarray,
                      u: np.ndarray, v: np.ndarray):
    """Interpolator over one camera's regular [R, C] vector grid: image
    point -> (u_px, v_px), NaN outside the grid or where vectors are NaN."""
    from scipy.interpolate import RegularGridInterpolator

    xs = np.asarray(x_px, np.float64)[0, :]
    ys = np.asarray(y_px, np.float64)[:, 0]
    flip_x = xs[0] > xs[-1]
    flip_y = ys[0] > ys[-1]
    if flip_x:
        xs = xs[::-1]
    if flip_y:
        ys = ys[::-1]

    def prep(f):
        f = np.asarray(f, np.float64)
        if flip_x:
            f = f[:, ::-1]
        if flip_y:
            f = f[::-1, :]
        return f

    fi = RegularGridInterpolator(
        (ys, xs), np.stack([prep(u), prep(v)], axis=-1),
        bounds_error=False, fill_value=np.nan)

    def sample(X, Y):
        out = fi(np.stack([np.asarray(Y, np.float64).ravel(),
                           np.asarray(X, np.float64).ravel()], axis=1))
        return (out[:, 0].reshape(np.shape(X)), out[:, 1].reshape(np.shape(X)))

    return sample


def reconstruct_from_grids(
    cam1: CameraMapping,
    cam2: CameraMapping,
    field1: Dict[str, np.ndarray],
    field2: Dict[str, np.ndarray],
    z: float = 0.0,
    shape: Optional[Tuple[int, int]] = None,
    window: Optional[Tuple[float, float, float, float]] = None,
) -> Dict[str, np.ndarray]:
    """Full raw-frame stereo workflow: two per-camera PIV results -> 3C
    world displacement field.

    Each ``field`` is a dict with 2-D ``x``/``y`` (the camera's vector-grid
    PIXEL coordinates, as the engine saves them) and ``u``/``v`` (pixel
    displacements, NaN where invalid).  The world analysis grid is the
    intersection of the two cameras' fields of view at height ``z``
    (override with ``window = (x_min, x_max, y_min, y_max)``), sampled at
    ``shape`` points (default: camera 1's grid shape).  Each camera's
    displacement field is interpolated at the image projection of every
    world grid point and the stacked 4-equation system is solved per point
    (``stereo_reconstruct``).

    Returns ``{"x", "y", "dx", "dy", "dz", "residual"}`` — world units,
    NaN outside the overlap or where either camera's vectors are invalid.
    """
    f1 = {k: np.asarray(field1[k], np.float64) for k in ("x", "y", "u", "v")}
    f2 = {k: np.asarray(field2[k], np.float64) for k in ("x", "y", "u", "v")}
    if shape is None:
        shape = f1["x"].shape
    if window is None:
        # world bounding box of each camera's vector grid corners, at z
        boxes = []
        for cam, f in ((cam1, f1), (cam2, f2)):
            cx = f["x"][[0, 0, -1, -1], [0, -1, 0, -1]]
            cy = f["y"][[0, 0, -1, -1], [0, -1, 0, -1]]
            wx, wy = cam.inverse(cx, cy, z)
            boxes.append((wx.min(), wx.max(), wy.min(), wy.max()))
        window = (max(b[0] for b in boxes), min(b[1] for b in boxes),
                  max(b[2] for b in boxes), min(b[3] for b in boxes))
        if window[0] >= window[1] or window[2] >= window[3]:
            raise ValueError(
                f"camera fields of view do not overlap at z={z}: {boxes}")
    xg, yg = np.meshgrid(np.linspace(window[0], window[1], shape[1]),
                         np.linspace(window[2], window[3], shape[0]))
    samplers = (_px_field_sampler(f1["x"], f1["y"], f1["u"], f1["v"]),
                _px_field_sampler(f2["x"], f2["y"], f2["u"], f2["v"]))
    uv = []
    for cam, sample in zip((cam1, cam2), samplers):
        X, Y = cam.project(xg, yg, z)
        uv.append(sample(X, Y))
    bad = np.zeros(shape, bool)
    for u, v in uv:
        bad |= ~np.isfinite(u) | ~np.isfinite(v)
    # NaNs poison LAPACK solves on some BLAS builds — zero them and mask after
    uv = [(np.where(bad, 0.0, u), np.where(bad, 0.0, v)) for u, v in uv]
    dx, dy, dz, rms = stereo_reconstruct(cam1, cam2, xg, yg, uv[0], uv[1], z)
    nan = np.where(bad, np.nan, 1.0)
    return {"x": xg, "y": yg, "dx": dx * nan, "dy": dy * nan,
            "dz": dz * nan, "residual": rms * nan}
