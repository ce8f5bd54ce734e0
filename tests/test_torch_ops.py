"""The port's torch ops against the JAX package's on the same numpy inputs:
window extraction (exact), FFT correlation (1e-4 of the map maximum: the
two FFT libraries sum in different orders), the gauss3 peak fit with
peak-ratio validation (u, v within 1e-5 px, invalid mask exact), also
against the fused TPU peak-fit kernel in interpret mode, which the port's
CUDA peak-fit kernel replaces, and the host infill (exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.experimental.peakfit_pallas import correlation_to_displacement_pallas
from torchpiv_tpu.ops import correlate as jcorr
from torchpiv_tpu.ops import infill as jinfill
from torchpiv_tpu.ops import peakfit as jpeak
from torchpiv_tpu.ops import windows as jwin
from torchpiv_tpu_torch.ops.correlate import correlate_fft, min_subtract
from torchpiv_tpu_torch.ops.infill import fill_missing_values, interpolate_borders
from torchpiv_tpu_torch.kernels.peakfit import peakfit
from torchpiv_tpu_torch.ops.peakfit import correlation_to_displacement
from torchpiv_tpu_torch.ops.windows import extract_windows


@pytest.mark.parametrize("shape,w,o", [
    ((128, 160), 32, 16),  # stride divides the window
    ((96, 128), 16, 12),  # 75% overlap
    ((100, 90), 24, 8),  # stride does not divide the window
])
def test_extract_windows_exact(shape, w, o):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, *shape)).astype(np.float32)
    got = extract_windows(torch.from_numpy(frames), w, o).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(jwin.extract_windows(jnp.asarray(frames[b]), w, o)))


@pytest.mark.parametrize("dc_normalize", [False, True])
@pytest.mark.parametrize("w", [16, 32])
def test_correlate_fft_matches_jax(dc_normalize, w):
    rng = np.random.default_rng(1)
    a = rng.uniform(1, 255, (2, 6, w, w)).astype(np.float32)
    b = rng.uniform(1, 255, (2, 6, w, w)).astype(np.float32)
    got = correlate_fft(torch.from_numpy(a), torch.from_numpy(b), dc_normalize).numpy()
    want = np.asarray(jcorr.correlate_fft(jnp.asarray(a), jnp.asarray(b), dc_normalize))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(
        min_subtract(torch.from_numpy(want.copy())).numpy(),
        np.asarray(jcorr.min_subtract(jnp.asarray(want))))


def _maps(d=16):
    """Peak-fit corner cases: random maps, a smooth peak, exact ties, peaks
    on every edge and corner (flat-index neighbour wrap and clamp), flat
    and near-flat (degenerate) maps, and a map whose second peak sits right
    outside the exclusion window."""
    rng = np.random.default_rng(2)
    maps = [rng.uniform(0, 1, (d, d)) for _ in range(6)]
    yy, xx = np.mgrid[:d, :d]
    maps.append(np.exp(-((yy - 7.3) ** 2 + (xx - 9.6) ** 2) / 3.0))
    tie = rng.uniform(0, 0.5, (d, d))
    tie[3, 4] = tie[10, 12] = 1.0
    maps.append(tie)
    for r, c in [(0, 0), (0, d - 1), (d - 1, 0), (d - 1, d - 1), (0, 5),
                 (d - 1, 7), (6, 0), (9, d - 1), (1, 1), (d - 2, d - 2)]:
        m = rng.uniform(0, 0.3, (d, d))
        m[r, c] = 1.0
        maps.append(m)
    maps.append(np.full((d, d), 0.25))
    maps.append(np.zeros((d, d)))
    two = rng.uniform(0, 0.1, (d, d))
    two[8, 8] = 1.0
    two[8, 12] = 0.9
    maps.append(two)
    return np.stack(maps).astype(np.float32)


@pytest.mark.parametrize("min_sub", [False, True])
@pytest.mark.parametrize("validate", [False, True])
def test_peakfit_matches_jax(min_sub, validate):
    maps = _maps()
    if min_sub:
        maps = maps * 40.0 - 7.0  # raw maps with a per-window offset
    tu, tv, ti = correlation_to_displacement(
        torch.from_numpy(maps), validate, 1.2, 3, min_subtract=min_sub)
    ju, jv, ji = jpeak.correlation_to_displacement(
        jnp.asarray(maps), validate, 1.2, 3, min_subtract=min_sub)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    if validate:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.any() and not ti.all()
    else:
        assert ti is None and ji is None


@pytest.mark.parametrize("window", [1, 3, 5])
def test_peakfit_exclusion_window_matches_jax(window):
    maps = _maps(d=32)
    _, _, ti = correlation_to_displacement(torch.from_numpy(maps), True, 1.1, window)
    _, _, ji = jpeak.correlation_to_displacement(jnp.asarray(maps), True, 1.1, window)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("min_sub", [False, True])
@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("d", [16, 32])
def test_peakfit_matches_pallas_kernel(d, min_sub, validate):
    """The plain version of the CUDA peak-fit kernel (reached through the
    kernel's wrapper on CPU tensors) against the TPU kernel it replaces.

    With ``min_subtract`` the TPU kernel computes ``(x - min) + EPS`` and the
    XLA fit, whose twin the plain version is, ``x + (EPS - min)``, which
    loses EPS once ``|min| >= 2``.  The two differ only for a sample within
    about 2 of the map minimum, so every map here gets one pedestal pixel
    below all others, away from the peaks, and no sample that the fit reads
    is the minimum."""
    maps = _maps(d)
    if min_sub:
        maps[:, d // 2 + 3, d // 2 + 4] = maps.min(axis=(1, 2)) - 1.0
        maps = maps * 40.0 - 7.0
    before = peakfit.launches
    tu, tv, ti = peakfit(torch.from_numpy(maps), validate, 1.2, 3, min_subtract=min_sub)
    assert peakfit.launches == before  # no kernel on the CPU
    ju, jv, ji = correlation_to_displacement_pallas(
        jnp.asarray(maps), validate, 1.2, 3, interpret=True, min_subtract=min_sub)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    if validate:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.any() and not ti.all()
    else:
        assert ti is None and ji is None


@pytest.mark.parametrize("window", [1, 3, 5])
def test_peakfit_exclusion_window_matches_pallas_kernel(window):
    maps = _maps(d=32)
    _, _, ti = peakfit(torch.from_numpy(maps), True, 1.1, window)
    _, _, ji = correlation_to_displacement_pallas(
        jnp.asarray(maps), True, 1.1, window, interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("bad", [
    torch.zeros(3, 16, 24), torch.zeros(16, 16), torch.zeros(2, 16, 16).double(),
    torch.zeros(1, 256, 256)])
def test_peakfit_wrapper_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        peakfit(bad)


def _holey_field(seed, frac=0.2, shape=(12, 15)):
    rng = np.random.default_rng(seed)
    f = rng.normal(2.0, 0.5, shape)
    f[rng.uniform(size=shape) < frac] = np.nan
    f[0, :4] = np.nan  # a border run
    return f


@pytest.mark.parametrize("seed,frac,skipped", [
    (0, 0.1, False), (1, 0.05, False), (2, 0.3, True), (3, 0.0, False)])
def test_host_infill_matches_jax(seed, frac, skipped):
    f = _holey_field(seed, frac)
    np.testing.assert_array_equal(interpolate_borders(f.copy()),
                                  jinfill.interpolate_borders(f.copy()))
    got = fill_missing_values(interpolate_borders(f.copy()))
    want = jinfill.fill_missing_values(jinfill.interpolate_borders(f.copy()))
    assert (got is None) == (want is None) == skipped
    if not skipped:
        np.testing.assert_array_equal(got, want)


def test_interpolate_borders_leaves_all_nan_border():
    f = np.full((4, 5), np.nan)
    f[1:3, 1:4] = 1.0
    np.testing.assert_array_equal(interpolate_borders(f.copy()),
                                  jinfill.interpolate_borders(f.copy()))
