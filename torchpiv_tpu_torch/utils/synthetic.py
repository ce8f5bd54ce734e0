"""Synthetic PIV image pairs with known displacement (numpy).

Copy of ``torchpiv_tpu/utils/synthetic.py``: random Gaussian particles
rendered into frame A, advected by a prescribed flow, and re-rendered into
frame B (``render_particles``, ``particle_pair``, ``shear_flow``), and the
contaminated and camera-degraded pairs of the validation campaign
(``static_background``, ``camera_degraded_pair``, ``contaminated_pair``,
``:110-245`` there).  The same seed gives the same bytes.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def render_particles(
    shape: Tuple[int, int],
    xs: np.ndarray,
    ys: np.ndarray,
    intensity: np.ndarray,
    diameter: float = 2.5,
) -> np.ndarray:
    """Render Gaussian particle images onto a float frame (additive)."""
    H, W = shape
    frame = np.zeros((H, W), dtype=np.float32)
    sigma = diameter / 2.354  # FWHM -> sigma
    r = max(2, int(np.ceil(3 * sigma)))
    span = np.arange(-r, r + 1)

    cx = np.round(xs).astype(np.int64)
    cy = np.round(ys).astype(np.int64)
    fx = xs - cx
    fy = ys - cy

    # Per-particle separable Gaussian stamps accumulated with add.at.
    gx = np.exp(-((span[None, :] - fx[:, None]) ** 2) / (2 * sigma**2))
    gy = np.exp(-((span[None, :] - fy[:, None]) ** 2) / (2 * sigma**2))
    stamps = intensity[:, None, None] * gy[:, :, None] * gx[:, None, :]

    iy = cy[:, None] + span[None, :]
    ix = cx[:, None] + span[None, :]
    ok = (
        (iy[:, :, None] >= 0)
        & (iy[:, :, None] < H)
        & (ix[:, None, :] >= 0)
        & (ix[:, None, :] < W)
    )
    iyc = np.clip(iy, 0, H - 1)
    ixc = np.clip(ix, 0, W - 1)
    np.add.at(
        frame,
        (
            np.broadcast_to(iyc[:, :, None], stamps.shape),
            np.broadcast_to(ixc[:, None, :], stamps.shape),
        ),
        np.where(ok, stamps, 0.0),
    )
    return frame


def particle_pair(
    shape: Tuple[int, int] = (512, 512),
    displacement: Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]
    | Tuple[float, float] = (3.3, -2.1),
    density: float = 0.02,
    diameter: float = 2.5,
    noise: float = 2.0,
    background: float = 8.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generate a uint8 frame pair with known displacement.

    ``displacement`` is either a constant ``(u, v)`` in pixels (u = +x/cols,
    v = +y/rows, image coordinates) or a callable ``(x, y) -> (u, v)`` over
    particle positions for non-uniform flow (e.g. shear).
    """
    H, W = shape
    rng = np.random.default_rng(seed)
    n = int(density * H * W)
    margin = 16
    xs = rng.uniform(-margin, W + margin, n)
    ys = rng.uniform(-margin, H + margin, n)
    inten = rng.uniform(100, 220, n)

    if callable(displacement):
        u, v = displacement(xs, ys)
    else:
        u = np.full(n, displacement[0])
        v = np.full(n, displacement[1])

    fa = render_particles((H, W), xs, ys, inten, diameter)
    fb = render_particles((H, W), xs + u, ys + v, inten, diameter)

    def finish(f):
        f = f + background + rng.normal(0, noise, f.shape)
        return np.clip(f, 0, 255).astype(np.uint8)

    return finish(fa), finish(fb)


def shear_flow(u0: float = 1.0, du_dy: float = 0.004):
    """Linear shear: u(y) = u0 + du_dy * y, v = 0."""

    def disp(xs, ys):
        return u0 + du_dy * ys, np.zeros_like(xs)

    return disp


def static_background(
    shape: Tuple[int, int],
    amplitude: float,
    seed: int = 0,
    smoothness: int = 12,
) -> np.ndarray:
    """Stationary textured background (wall reflections / laser glare):
    a smooth non-negative random field, meant to be ADDED to both frames
    of a pair.  Such frame-correlated contamination plants a spurious
    zero-displacement peak in standard cross-correlation; it is the regime
    where robust phase correlation (``PIVConfig(correlation="rpc")``)
    materially beats SCC (see docs/ACCURACY.md)."""
    from scipy.ndimage import uniform_filter

    rng = np.random.default_rng(seed)
    f = rng.normal(0.0, 1.0, shape)
    for _ in range(3):
        f = uniform_filter(f, smoothness, mode="reflect")
    f = f / np.abs(f).max() * amplitude
    return f - f.min()


def camera_degraded_pair(
    shape: Tuple[int, int],
    displacement=(3.3, -2.1),
    density: float = 0.012,
    diameter: float = 2.5,
    dropout: float = 0.15,
    intensity_flicker: float = 0.25,
    vignette: float = 0.55,
    glare_amplitude: float = 45.0,
    read_noise: float = 4.0,
    shot_noise: bool = True,
    hot_pixel_rate: float = 3e-5,
    seeding_gradient: float = 0.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """A frame pair degraded like a real PIV camera recording — the
    validation stand-in for the reference's real ``test_images/`` dataset
    (not in its published snapshot; its README.md:34 quotes numbers from
    it).  Degradations, each individually
    controllable:

    * **out-of-plane dropout** — a fraction ``dropout`` of frame-A
      particles leaves the light sheet before frame B; an equal number of
      fresh particles enters (seeding density stays constant, pairing
      information is lost for those particles).
    * **intensity flicker** — per-particle lognormal brightness change
      between frames (movement within the Gaussian sheet profile).
    * **vignetting** — multiplicative radial illumination falloff
      ``1 - vignette * (r / r_corner)^2`` on particles AND glare (it is an
      illumination/collection effect, not a sensor offset).
    * **glare** — stationary background texture added to both frames
      (wall reflection / flare); frame-correlated, plants a spurious
      zero-displacement correlation peak.
    * **sensor noise** — Poisson shot noise on the collected signal plus
      Gaussian read noise, i.i.d. per frame.
    * **hot pixels** — saturated stuck pixels at fixed sensor sites
      (identical in both frames, like a real defect map).
    * **inhomogeneous seeding** — ``seeding_gradient`` in [0, 1) thins the
      particle density linearly across x down to ``1 - seeding_gradient``
      of nominal at the right edge (uneven tracer feed / sheet cut-off),
      applied identically to both frames' particle sets.
    """
    H, W = shape
    rng = np.random.default_rng(seed)
    n = int(density * H * W)
    margin = 16
    xs = rng.uniform(-margin, W + margin, n)
    ys = rng.uniform(-margin, H + margin, n)
    inten = rng.uniform(100, 220, n)
    if seeding_gradient:
        if not 0.0 <= seeding_gradient < 1.0:
            raise ValueError("seeding_gradient must be in [0, 1)")
        p_keep = 1.0 - seeding_gradient * np.clip(xs / W, 0.0, 1.0)
        sel = rng.random(n) < p_keep
        xs, ys, inten = xs[sel], ys[sel], inten[sel]
        n = xs.size

    if callable(displacement):
        u, v = displacement(xs, ys)
    else:
        u = np.full(n, displacement[0])
        v = np.full(n, displacement[1])

    # frame B particle set: survivors (advected, flickered) + replacements
    keep = rng.random(n) >= dropout
    flick = np.exp(rng.normal(0.0, intensity_flicker, n))
    xs_b = np.concatenate([
        (xs + u)[keep],
        rng.uniform(-margin, W + margin, int((~keep).sum())),
    ])
    ys_b = np.concatenate([
        (ys + v)[keep],
        rng.uniform(-margin, H + margin, int((~keep).sum())),
    ])
    inten_b = np.concatenate([
        (inten * flick)[keep],
        rng.uniform(100, 220, int((~keep).sum())),
    ])

    fa = render_particles((H, W), xs, ys, inten, diameter)
    fb = render_particles((H, W), xs_b, ys_b, inten_b, diameter)

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    r2 = ((yy - (H - 1) / 2) ** 2 + (xx - (W - 1) / 2) ** 2)
    vig = 1.0 - vignette * r2 / r2.max()
    glare = static_background(shape, glare_amplitude, seed=seed + 7919)
    hot = rng.random((H, W)) < hot_pixel_rate  # fixed sensor defect map

    def finish(f):
        signal = (f + glare) * vig
        if shot_noise:
            signal = rng.poisson(np.maximum(signal, 0.0)).astype(np.float64)
        signal = signal + 8.0 + rng.normal(0, read_noise, f.shape)
        signal[hot] = 255.0
        return np.clip(signal, 0, 255).astype(np.uint8)

    return finish(fa), finish(fb)


def contaminated_pair(
    shape: Tuple[int, int],
    displacement=(3.3, -2.1),
    bg_amplitude: float = 80.0,
    seed: int = 0,
    **pair_kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """A ``particle_pair`` with a stationary background added to both
    frames (amplitude in grey levels), clipped back to uint8."""
    fa, fb = particle_pair(shape, displacement=displacement, seed=seed,
                           **pair_kwargs)
    bg = static_background(shape, bg_amplitude, seed=seed + 7919)
    fa = np.clip(fa.astype(np.float64) + bg, 0, 255).astype(np.uint8)
    fb = np.clip(fb.astype(np.float64) + bg, 0, 255).astype(np.uint8)
    return fa, fb
