"""Polynomial camera mappings (Soloff calibration);
a copy of ``torchpiv_tpu/calib/mapping.py``.

The standard stereo-PIV camera model (Soloff, Adrian & Liu, Meas. Sci.
Technol. 8 1997): each camera's world->image projection is fitted as a
polynomial — cubic in the in-plane world coordinates (x, y), quadratic in
the out-of-plane coordinate z — from images of a calibration target at a
few known z positions.  No pinhole parameters are needed; lens distortion
and oblique viewing are absorbed by the polynomial.

Everything here is host-side numpy: calibration runs once per experiment
and dewarping/reconstruction operate on the tiny final vector fields, not
on the image stream (the hot path stays in the jitted engine).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# Soloff basis: all monomials x^i y^j z^k with i+j <= 3, k <= 2, and
# total degree capped so the classic 19-term basis is reproduced.
_EXPONENTS = [
    (i, j, k)
    for k in range(3)
    for i in range(4)
    for j in range(4)
    if i + j <= 3 and (k < 2 or i + j <= 1)
]


def _basis(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """[N, n_terms] Soloff monomial matrix."""
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    z = np.asarray(z, np.float64).ravel()
    return np.stack([x**i * y**j * z**k for i, j, k in _EXPONENTS], axis=1)


def _basis_grad(x, y, z):
    """d(basis)/dx, /dy, /dz — each [N, n_terms]."""
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    z = np.asarray(z, np.float64).ravel()
    gx, gy, gz = [], [], []
    for i, j, k in _EXPONENTS:
        gx.append(i * x ** max(i - 1, 0) * y**j * z**k if i else 0 * x)
        gy.append(x**i * j * y ** max(j - 1, 0) * z**k if j else 0 * x)
        gz.append(x**i * y**j * k * z ** max(k - 1, 0) if k else 0 * x)
    return (np.stack(gx, 1), np.stack(gy, 1), np.stack(gz, 1))


class CameraMapping:
    """World (x, y, z) -> image (X, Y) polynomial mapping for one camera.

    Fit from calibration-target points with ``fit``; evaluate with
    ``project``; differentiate with ``jacobian`` (the quantity stereo
    reconstruction needs).  Units are whatever the calibration target used
    (typically mm for world, px for image).
    """

    def __init__(self, coef_x: np.ndarray, coef_y: np.ndarray,
                 fit_rms_px: float = float("nan")):
        self.coef_x = np.asarray(coef_x, np.float64)
        self.coef_y = np.asarray(coef_y, np.float64)
        self.fit_rms_px = float(fit_rms_px)

    @classmethod
    def fit(
        cls,
        world: np.ndarray,
        image: np.ndarray,
    ) -> "CameraMapping":
        """Least-squares Soloff fit.

        Args:
          world: ``[N, 3]`` target-point world coordinates (x, y, z) —
            include at least two z planes for stereo use (a single plane
            leaves the z terms unconstrained; they are then zeroed).
          image: ``[N, 2]`` the corresponding detected image points (X, Y).
        """
        world = np.asarray(world, np.float64)
        image = np.asarray(image, np.float64)
        if world.ndim != 2 or world.shape[1] != 3:
            raise ValueError("world must be [N, 3]")
        if image.shape != (world.shape[0], 2):
            raise ValueError("image must be [N, 2] matching world")
        A = _basis(world[:, 0], world[:, 1], world[:, 2])
        # single-plane calibration: z columns are constant -> rank-deficient;
        # drop the z-dependent terms and zero their coefficients
        z_dependent = np.array([k > 0 for _, _, k in _EXPONENTS])
        single_plane = np.ptp(world[:, 2]) == 0
        cols = ~z_dependent if single_plane else np.ones(len(_EXPONENTS), bool)
        cx = np.zeros(len(_EXPONENTS))
        cy = np.zeros(len(_EXPONENTS))
        sol, *_ = np.linalg.lstsq(A[:, cols], image, rcond=None)
        cx[cols] = sol[:, 0]
        cy[cols] = sol[:, 1]
        rms = float(np.sqrt(np.mean((A[:, cols] @ sol - image) ** 2)))
        return cls(cx, cy, fit_rms_px=rms)

    def save(self, path: str) -> str:
        """Persist to ``.npz`` (coefficients + fit residual)."""
        np.savez(path, coef_x=self.coef_x, coef_y=self.coef_y,
                 fit_rms_px=self.fit_rms_px, format=np.int64(1))
        return path if path.endswith(".npz") else path + ".npz"

    @classmethod
    def load(cls, path: str) -> "CameraMapping":
        with np.load(path) as d:
            if d["coef_x"].shape != (len(_EXPONENTS),):
                raise ValueError(
                    f"{path}: not a torchpiv-tpu camera calibration file")
            return cls(d["coef_x"], d["coef_y"],
                       fit_rms_px=float(d["fit_rms_px"]))

    def project(self, x, y, z=0.0) -> Tuple[np.ndarray, np.ndarray]:
        """World points -> image points, preserving the input shape."""
        shape = np.broadcast(np.asarray(x), np.asarray(y)).shape
        z = np.broadcast_to(np.asarray(z, np.float64), shape)
        A = _basis(np.broadcast_to(x, shape), np.broadcast_to(y, shape), z)
        return (A @ self.coef_x).reshape(shape), (A @ self.coef_y).reshape(shape)

    def inverse(self, X, Y, z=0.0, iters: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """Image points -> in-plane world points at height ``z`` (Newton).

        Starts from the affine part of the mapping (exact for a distortion-
        free camera) and refines with the local 2x2 in-plane Jacobian; the
        polynomial is smooth and near-affine over any sane field of view, so
        a handful of iterations reach float64 roundoff.
        """
        shape = np.broadcast(np.asarray(X), np.asarray(Y)).shape
        X = np.broadcast_to(np.asarray(X, np.float64), shape)
        Y = np.broadcast_to(np.asarray(Y, np.float64), shape)
        # affine initialisation from three probe points at this z
        X0, Y0 = self.project(0.0, 0.0, z)
        J0 = self.jacobian(0.0, 0.0, z)[..., :, :2]  # [2, 2]
        rhs = np.stack([X - X0, Y - Y0], axis=-1)[..., None]
        xy = np.linalg.solve(np.broadcast_to(J0, shape + (2, 2)), rhs)[..., 0]
        x, y = xy[..., 0], xy[..., 1]
        for _ in range(iters):
            Xp, Yp = self.project(x, y, z)
            r = np.stack([X - Xp, Y - Yp], axis=-1)[..., None]
            J = self.jacobian(x, y, z)[..., :, :2]
            step = np.linalg.solve(J, r)[..., 0]
            x = x + step[..., 0]
            y = y + step[..., 1]
            if float(np.nanmax(np.abs(step))) < 1e-12:
                break
        return x, y

    def jacobian(self, x, y, z=0.0) -> np.ndarray:
        """``[..., 2, 3]`` d(image)/d(world) at the given world points."""
        shape = np.broadcast(np.asarray(x), np.asarray(y)).shape
        z = np.broadcast_to(np.asarray(z, np.float64), shape)
        gx, gy, gz = _basis_grad(
            np.broadcast_to(x, shape), np.broadcast_to(y, shape), z)
        J = np.empty(shape + (2, 3))
        for col, g in enumerate((gx, gy, gz)):
            J[..., 0, col] = (g @ self.coef_x).reshape(shape)
            J[..., 1, col] = (g @ self.coef_y).reshape(shape)
        return J


def dewarp_field(
    mapping: CameraMapping,
    x_world: np.ndarray,
    y_world: np.ndarray,
    u_px: np.ndarray,
    v_px: np.ndarray,
    z: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convert one camera's pixel displacements to in-plane world units.

    Inverts the local 2x2 in-plane Jacobian at each grid point:
    ``(du_px, dv_px) = J[:, :2] @ (dx, dy)``.  Out-of-plane motion is
    unobservable with one camera (use ``stereo_reconstruct`` for 3C).
    """
    J = mapping.jacobian(x_world, y_world, z)[..., :, :2]  # [..., 2, 2]
    rhs = np.stack([np.asarray(u_px, np.float64),
                    np.asarray(v_px, np.float64)], axis=-1)[..., None]
    sol = np.linalg.solve(J, rhs)[..., 0]
    return sol[..., 0], sol[..., 1]


def world_grid(x0: float, y0: float, pitch: float,
               shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Regular [R, C] world grid: ``x = x0 + pitch*j``, ``y = y0 + pitch*i``
    (world y along image rows, matching the engine's row-major coordinate
    convention — reference PIVbackend.py get_coordinates)."""
    rows, cols = shape
    xs = x0 + pitch * np.arange(cols, dtype=np.float64)
    ys = y0 + pitch * np.arange(rows, dtype=np.float64)
    return np.meshgrid(xs, ys)


def dewarp_image(
    mapping: CameraMapping,
    frame: np.ndarray,
    x0: float,
    y0: float,
    pitch: float,
    shape: Tuple[int, int],
    z: float = 0.0,
    order: int = 1,
) -> np.ndarray:
    """Resample a raw camera frame onto a regular world grid.

    Pixel ``(i, j)`` of the output shows the world point
    ``(x0 + pitch*j, y0 + pitch*i, z)``; run PIV on dewarped frame pairs
    and pixel displacements become world displacements times ``pitch``
    directly (the per-camera input to stereo workflows that analyse in
    the common world frame).  ``order``: 1 = bilinear, 3 = cubic spline.
    Returns a float32 [R, C] image; world points outside the frame are 0.
    """
    from scipy.ndimage import map_coordinates

    xg, yg = world_grid(x0, y0, pitch, shape)
    X, Y = mapping.project(xg, yg, z)
    return map_coordinates(
        np.asarray(frame, np.float32), [Y, X], order=order,
        mode="constant", cval=0.0).astype(np.float32)
