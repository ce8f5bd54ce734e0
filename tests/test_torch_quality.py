"""The port's ``stats/quality.py`` on the CPU against the JAX package's.

The three maps at the engine's pass windows (w32/o16, w64/o32): <= 1e-4
relative on the windows where both are finite, and the same NaN pattern
(measured on these inputs: 9.3e-7 for ``snr_map``, 2.7e-6 for
``peak_width_map``, 6.6e-6 for ``uncertainty_map``; the JAX package
correlates through its matmul DFT, the port through ``torch.fft``).

At w16/o8 the uncertainty map's noise floor is the spread of correlation
samples that differ from the plane's mean by about 1e-3 of it, and the JAX
package's float32 matmul DFT reads 2.1e-3 to 3.5e-3 relative from a
float64 evaluation of the same formula (measured), so there the port is
held to that float64 evaluation (``_uncertainty_f64``) instead: <= 1e-4
relative [1.7e-5].  ``fractional_histogram`` and ``peak_locking_degree``
are copies: equal."""
import numpy as np
import pytest
import torch

from torchpiv_tpu.stats import quality as jax_quality
from torchpiv_tpu_torch.stats import quality
from torchpiv_tpu_torch.utils.synthetic import particle_pair, shear_flow

SHAPE = (128, 128)


def _pair(flow, seed=5):
    if flow == "uniform":
        return particle_pair(SHAPE, (3.3, -2.1), seed=seed)
    if flow == "shear":
        return particle_pair(SHAPE, shear_flow(1.0, 0.05), seed=seed)
    # sparse seeding with a blank band: low-SNR and degenerate windows
    fa, fb = particle_pair(SHAPE, (1.4, 0.6), density=0.004, seed=seed)
    fa[:, :40] = 0
    fb[:, :40] = 0
    return fa, fb


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= 1e-4 * np.abs(want[fin])).all()


WINDOWS = [(32, 16), (64, 32)]


@pytest.mark.parametrize("flow", ["uniform", "shear", "sparse"])
@pytest.mark.parametrize("w,o", WINDOWS)
def test_snr_map_matches_jax(flow, w, o):
    fa, fb = _pair(flow)
    for vw in (3, 1):
        got = quality.snr_map(fa, fb, w, o, validation_window=vw, device="cpu")
        _close(got, jax_quality.snr_map(fa, fb, w, o, validation_window=vw))


@pytest.mark.parametrize("flow", ["uniform", "shear", "sparse"])
@pytest.mark.parametrize("w,o", WINDOWS)
def test_peak_width_map_matches_jax(flow, w, o):
    fa, fb = _pair(flow)
    for got, want in zip(quality.peak_width_map(fa, fb, w, o, device="cpu"),
                         jax_quality.peak_width_map(fa, fb, w, o)):
        _close(got, want)


@pytest.mark.parametrize("flow", ["uniform", "shear", "sparse"])
@pytest.mark.parametrize("w,o", WINDOWS)
def test_uncertainty_map_matches_jax(flow, w, o):
    fa, fb = _pair(flow)
    for ew in (3, 2):
        for got, want in zip(
                quality.uncertainty_map(fa, fb, w, o, exclusion_window=ew, device="cpu"),
                jax_quality.uncertainty_map(fa, fb, w, o, exclusion_window=ew)):
            _close(got, want)


def _uncertainty_f64(fa, fb, w, o, ew=3):
    """``uncertainty_map`` in float64 numpy: windows, mean normalisation,
    ``numpy.fft`` correlation, the exclusion and the propagation formula."""
    step = w - o
    R = (fa.shape[0] - w) // step + 1
    C = (fa.shape[1] - w) // step + 1

    def windows(f):
        f = f.astype(np.float64)
        x = np.stack([f[r * step:r * step + w, c * step:c * step + w]
                      for r in range(R) for c in range(C)])
        return x / x.mean(axis=(1, 2), keepdims=True)

    a, b = windows(fa), windows(fb)
    corr = np.fft.fftshift(np.fft.irfft2(np.conj(np.fft.rfft2(a)) * np.fft.rfft2(b),
                                         s=(w, w)), axes=(1, 2))
    n, kd = len(corr), w * w
    flat = corr.reshape(n, kd)
    flat = flat + (1e-7 - flat.min(axis=1, keepdims=True))
    m = flat.argmax(axis=1)

    def at(d):
        return flat[np.arange(n), np.clip(m + d, 0, kd - 1)]

    dd = np.arange(kd)[None] - m[:, None]
    j = np.round(dd / w)
    excl = (np.abs(j) <= ew) & (np.abs(dd - w * j) <= ew)
    excl[:, 0] |= (m - (ew + w * ew)) < 0
    excl[:, kd - 1] |= (m + (ew + w * ew)) > kd - 1
    cnt = (~excl).sum(axis=1)
    mean = np.where(excl, 0.0, flat).sum(axis=1) / cnt
    s = np.sqrt(np.where(excl, 0.0, (flat - mean[:, None]) ** 2).sum(axis=1)
                / np.maximum(cnt - 1, 1))
    cm = at(0)
    row, col = m // w, m % w
    interior = (row > 0) & (row < w - 1) & (col > 0) & (col < w - 1)

    def axis_sigma(cl, cr):
        L, Rr, M = np.log(cl), np.log(cr), np.log(cm)
        N = L - Rr
        D = 2 * L + 2 * Rr - 4 * M
        g2 = (((D - 2 * N) / (cl * D * D)) ** 2 + ((D + 2 * N) / (cr * D * D)) ** 2
              + ((4 * N) / (cm * D * D)) ** 2)
        return np.where(interior & (D < 0), s * np.sqrt(g2), np.nan).reshape(R, C)

    return axis_sigma(at(-1), at(1)), axis_sigma(at(-w), at(w))


@pytest.mark.parametrize("flow", ["uniform", "shear"])
@pytest.mark.parametrize("w,o", [(16, 8), (32, 16)])
def test_uncertainty_map_matches_float64(flow, w, o):
    fa, fb = _pair(flow)
    for got, want in zip(quality.uncertainty_map(fa, fb, w, o, device="cpu"),
                         _uncertainty_f64(fa, fb, w, o)):
        _close(got, want)


def test_maps_take_tensors_on_their_device():
    fa, fb = _pair("uniform")
    a, b = torch.from_numpy(fa), torch.from_numpy(fb)
    np.testing.assert_array_equal(quality.snr_map(a, b, 32, 16),
                                  quality.snr_map(fa, fb, 32, 16, device="cpu"))
    for got, want in zip(quality.peak_width_map(a, b, 32, 16),
                         quality.peak_width_map(fa, fb, 32, 16, device="cpu")):
        np.testing.assert_array_equal(got, want)


def test_peak_width_tracks_particle_size():
    """The correlation peak of particle images of diameter d is their
    autocorrelation: sigma = sqrt(2) * d / 2.354 (1.50 px at d = 2.5)."""
    fa, fb = _pair("uniform")
    sx, sy = quality.peak_width_map(fa, fb, 32, 16, device="cpu")
    want = np.sqrt(2.0) * 2.5 / 2.354
    assert abs(np.nanmedian(sx) / want - 1) < 0.25
    assert abs(np.nanmedian(sy) / want - 1) < 0.25


@pytest.mark.parametrize("bins", [10, 20])
def test_peak_locking_copies_equal(bins):
    rng = np.random.default_rng(3)
    u = np.round(rng.normal(0, 3, (20, 30)) * 2) / 2 + rng.normal(0, 0.05, (20, 30))
    mask = rng.random(u.shape) < 0.1
    for m in (None, mask):
        got = quality.fractional_histogram(u, bins, m)
        want = jax_quality.fractional_histogram(u, bins, m)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert quality.peak_locking_degree(u, bins, m) == \
            jax_quality.peak_locking_degree(u, bins, m)
    assert quality.peak_locking_degree(np.full(5, np.nan)) == 0.0
