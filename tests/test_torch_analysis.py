"""The port's copies of the JAX package's host-side analysis modules
(``stats/{derived,dmd,pod,pressure,spectra,spod,temporal,turbulence}.py``
and ``calib/``), each function equal to its original on the same seeded
inputs (``assert_array_equal`` on every array of the result: the copies are
the same numpy and scipy code)."""
import dataclasses
import types

import numpy as np
import pytest

import torchpiv_tpu.calib as jax_calib
import torchpiv_tpu.stats as jax_stats
import torchpiv_tpu_torch.calib as calib
import torchpiv_tpu_torch.stats as stats

PORT = types.SimpleNamespace(stats=stats, calib=calib)
JAX = types.SimpleNamespace(stats=jax_stats, calib=jax_calib)
SHAPE = (24, 32)


def _stack(seed, T=24, shape=SHAPE):
    """A travelling wave with noise and a few missing vectors: ``[T, R, C]``
    u and v."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None, None]
    y, x = np.mgrid[:shape[0], :shape[1]]
    u = 1.0 + 0.4 * np.sin(x / 5.0 - 0.5 * t) + 0.05 * rng.standard_normal((T, *shape))
    v = 0.3 * np.cos(y / 4.0 + 0.3 * t) + 0.05 * rng.standard_normal((T, *shape))
    return u, v


def _vortex(cx, cy, shape=SHAPE, core=3.0, sense=1.0):
    """A Lamb-Oseen vortex centred at ``(cx, cy)`` (grid units)."""
    y, x = np.mgrid[:shape[0], :shape[1]].astype(np.float64)
    dx, dy = x - cx, y - cy
    r2 = dx * dx + dy * dy + 1e-12
    vt = sense * (1.0 - np.exp(-r2 / core**2)) / np.sqrt(r2)
    return -vt * dy / np.sqrt(r2), vt * dx / np.sqrt(r2)


def _pinhole(theta_deg, dist=0.0):
    """A synthetic camera: rotation about y, weak perspective, a quadratic
    distortion."""
    th = np.radians(theta_deg)

    def proj(x, y, z):
        xr = np.cos(th) * x + np.sin(th) * z
        zr = -np.sin(th) * x + np.cos(th) * z
        X = 640.0 + 12.0 * xr * (1 - 1e-3 * zr) + dist * 1e-4 * (xr**2 + y**2)
        Y = 480.0 + 12.0 * y * (1 - 1e-3 * zr)
        return X, Y

    return proj


def _calib_points(proj):
    g = np.linspace(-20, 20, 9)
    xs, ys, zs = np.meshgrid(g, g, [-2.0, 0.0, 2.0], indexing="ij")
    world = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1)
    X, Y = proj(world[:, 0], world[:, 1], world[:, 2])
    return world, np.stack([X, Y], axis=1)


def _cams(pkg):
    return tuple(pkg.calib.CameraMapping.fit(*_calib_points(_pinhole(th, d)))
                 for th, d in ((30.0, 1.0), (-30.0, -0.5)))


def _dots(shape, pts, sigma=1.8, amp=220.0):
    """A calibration image: Gaussian dots at sub-pixel centres."""
    img = np.zeros(shape, np.float64)
    win = np.arange(-7, 8, dtype=np.float64)
    for X, Y in pts:
        xi, yi = int(round(X)), int(round(Y))
        gx = np.exp(-((win + xi - X) ** 2) / (2 * sigma**2))
        gy = np.exp(-((win + yi - Y) ** 2) / (2 * sigma**2))
        img[yi - 7:yi + 8, xi - 7:xi + 8] += amp * gy[:, None] * gx[None, :]
    return np.clip(img, 0, 255).astype(np.uint8)


def _dot_frame(z=0.0):
    g = np.linspace(-16, 16, 9)
    wx, wy = np.meshgrid(g, g)
    X, Y = _pinhole(30.0, 1.0)(wx.ravel(), wy.ravel(), z)
    return _dots((960, 1280), np.stack([X, Y], 1))


def _px_field(pkg, which):
    """A camera's pixel-displacement field of a known 3-D displacement."""
    cam = _cams(pkg)[which]
    proj = _pinhole(*((30.0, 1.0), (-30.0, -0.5))[which])
    Xg, Yg = np.meshgrid(np.arange(460, 830, 16.0), np.arange(300, 670, 16.0))
    xw, yw = cam.inverse(Xg, Yg, 0.0)
    X1, Y1 = proj(xw + 0.05, yw - 0.03 + 0.001 * yw, 0.02 * np.sin(xw / 8.0))
    u, v = X1 - Xg, Y1 - Yg
    u[2, 3] = np.nan  # an invalid vector
    return {"x": Xg, "y": Yg, "u": u, "v": v}


def _write_series(folder, seed):
    u, v = _stack(seed, T=5)
    y, x = np.mgrid[:SHAPE[0], :SHAPE[1]].astype(np.float64)
    for i in range(5):
        name = "run.npy" if i == 0 else f"run ({i}).npy"
        np.save(folder / name, np.stack([x, y, u[i], v[i]]))
    np.save(folder / "other.npy", np.zeros((3, 2, 2)))  # not a field
    return str(folder)


U, V = _stack(1)
VX, VY = _vortex(14.3, 11.6)
MOVING = [_vortex(6.0 + 1.2 * t, 12.0) for t in range(6)]
PROBE = np.sin(np.linspace(0, 12 * np.pi, 96)) + 0.1 * np.random.default_rng(2).standard_normal(96)

CASES = {
    "velocity_gradients": lambda p: p.stats.velocity_gradients(U[0], V[0], 0.5, 0.25),
    "vorticity": lambda p: p.stats.vorticity(VX, VY, 0.5, 0.5),
    "divergence": lambda p: p.stats.divergence(U[0], V[0], 0.5, 0.5),
    "swirling_strength": lambda p: p.stats.swirling_strength(VX, VY),
    "okubo_weiss": lambda p: p.stats.okubo_weiss(VX, VY, 2.0, 2.0),
    "derived_fields": lambda p: p.stats.derived_fields(VX, VY, 0.5, 0.5),
    "gamma_functions": lambda p: p.stats.gamma_functions(VX, VY, radius=2),
    "find_vortex_cores": lambda p: p.stats.find_vortex_cores(VX - 0.8 * _vortex(4.0, 4.0)[0], VY),
    "gradient_uncertainty": lambda p: p.stats.gradient_uncertainty(np.abs(U[1]) * 0.1,
                                                                   np.abs(V[1]) * 0.1, 0.5),
    "track_vortex_cores": lambda p: p.stats.track_vortex_cores(
        np.stack([m[0] for m in MOVING]), np.stack([m[1] for m in MOVING])),
    "compute_dmd": lambda p: p.stats.compute_dmd(U, V, dt=0.1, rank=6),
    "compute_pod": lambda p: p.stats.compute_pod(U, V, n_modes=5),
    "compute_spod": lambda p: p.stats.compute_spod(U, V, fs=10.0, n_fft=8, n_modes=2),
    "pressure_poisson": lambda p: p.stats.pressure_poisson(VX, VY, 0.5, 0.5, nu=1e-3),
    "pressure_from_stack": lambda p: p.stats.pressure_from_stack(U[:4], V[:4], 0.1, nu=1e-3),
    "mean_pressure_rans": lambda p: p.stats.mean_pressure_rans(
        U.mean(0), V.mean(0), U.var(0), V.var(0), ((U - U.mean(0)) * (V - V.mean(0))).mean(0)),
    "solve_poisson_neumann": lambda p: p.stats.solve_poisson_neumann(U[2] - U[2].mean(), 0.5, 0.5),
    "energy_spectrum": lambda p: p.stats.energy_spectrum(U[:6], V[:6], dx=0.5),
    "spatial_spectrum": lambda p: p.stats.spatial_spectrum(U[:6], dx=0.5, axis=-2),
    "dissipation_direct": lambda p: p.stats.dissipation_direct(U, V, nu=1e-3, dx=0.5, dy=0.5),
    "integral_length_scale": lambda p: p.stats.integral_length_scale(U, dx=0.5),
    "kolmogorov_scales": lambda p: p.stats.kolmogorov_scales(0.02, 1e-5),
    "taylor_microscale": lambda p: p.stats.taylor_microscale(0.3, 0.02, 1e-5),
    "taylor_reynolds": lambda p: p.stats.taylor_reynolds(0.3, 0.02, 1e-5),
    "turbulence_report": lambda p: p.stats.turbulence_report(U, V, nu=1e-3, dx=0.5, dy=0.5),
    "turbulent_kinetic_energy": lambda p: p.stats.turbulent_kinetic_energy(U.var(0), V.var(0)),
    "autocorrelation": lambda p: p.stats.autocorrelation(PROBE, max_lag=30),
    "convergence_report": lambda p: p.stats.convergence_report(U, V, fs=10.0),
    "integral_time_scale": lambda p: p.stats.integral_time_scale(U[:, :4, :5].reshape(len(U), -1), fs=10.0),
    "phase_average": lambda p: p.stats.phase_average(
        U, V, p.stats.phase_from_probe(U[:, 5, 7]), n_bins=4),
    "phase_from_probe": lambda p: p.stats.phase_from_probe(PROBE),
    "probe_series": lambda p: p.stats.probe_series(U, V, [(3, 4), (10, 20)]),
    "running_mean": lambda p: p.stats.running_mean(PROBE),
    "welch_psd": lambda p: p.stats.welch_psd(PROBE, fs=10.0, nperseg=32),
    "camera_mapping": lambda p: [(m.coef_x, m.coef_y, m.fit_rms_px, m.project(3.0, -2.0, 0.5),
                                  m.inverse(700.0, 500.0, 0.5), m.jacobian(1.0, 2.0, 0.0))
                                 for m in _cams(p)],
    "dewarp_field": lambda p: p.calib.dewarp_field(
        _cams(p)[0], *p.calib.world_grid(-5.0, -5.0, 1.0, (6, 7)),
        np.full((6, 7), 0.5), np.full((6, 7), -0.25)),
    "dewarp_image": lambda p: p.calib.dewarp_image(
        _cams(p)[0], _dot_frame(), -10.0, -10.0, 0.5, (30, 40)),
    "world_grid": lambda p: p.calib.world_grid(-3.0, 2.0, 0.25, (5, 9)),
    "stereo_reconstruct": lambda p: p.calib.stereo_reconstruct(
        *_cams(p), *p.calib.world_grid(-5.0, -5.0, 2.0, (5, 5)),
        (np.full((5, 5), 0.6), np.full((5, 5), -0.4)),
        (np.full((5, 5), 0.5), np.full((5, 5), -0.4))),
    "reconstruct_from_grids": lambda p: p.calib.reconstruct_from_grids(
        *_cams(p), _px_field(p, 0), _px_field(p, 1), z=0.0),
    "detect_dots": lambda p: p.calib.detect_dots(_dot_frame()),
    "detect_dot_grid": lambda p: p.calib.detect_dot_grid(_dot_frame(2.0), spacing=4.0, z=2.0),
    "order_into_grid": lambda p: p.calib.order_into_grid(p.calib.detect_dots(_dot_frame())),
}


def _assert_same(got, want, where="result"):
    """Equal structure, and equal arrays and numbers, recursively."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        _assert_same(vars(got), vars(want), where)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_equals_original(case):
    _assert_same(CASES[case](PORT), CASES[case](JAX))


def test_load_pair_stack_equals_original(tmp_path):
    folder = _write_series(tmp_path, 6)
    got = stats.load_pair_stack(folder)
    _assert_same(got, jax_stats.load_pair_stack(folder))
    assert got["u"].shape == (5, *SHAPE)
    # the bare name is snapshot 0
    np.testing.assert_array_equal(got["u"][0], np.load(tmp_path / "run.npy")[2])


def test_derived_tracks_cores_with_the_port_linker():
    """``track_vortex_cores`` links through the port's
    ``models.ptv.greedy_link_steps``: one track across the six frames."""
    tracks = stats.track_vortex_cores(np.stack([m[0] for m in MOVING]),
                                      np.stack([m[1] for m in MOVING]))
    assert max(len(t["frames"]) for t in tracks) == 6


def test_exports_match_the_jax_packages():
    assert sorted(stats.__all__) == sorted(jax_stats.__all__)
    assert sorted(calib.__all__) == sorted(jax_calib.__all__)
