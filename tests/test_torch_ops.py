"""The port's torch ops against the JAX package's on the same numpy inputs:
window extraction (exact), FFT correlation (1e-4 of the map maximum: the
two FFT libraries sum in different orders), the gauss3 peak fit with
peak-ratio validation (u, v within 1e-5 px, invalid mask exact), also
against the fused TPU peak-fit kernel in interpret mode, which the port's
CUDA peak-fit kernel replaces, the host infill (exact), and the robust
knobs' ops: the gauss2d fit and the second-peak candidates (1e-5 px), the
RPC filter (exact) and robust phase correlation, the explicit mean
normalisation, and the device infill (1e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.experimental.peakfit_pallas import correlation_to_displacement_pallas
from torchpiv_tpu.ops import correlate as jcorr
from torchpiv_tpu.ops import infill as jinfill
from torchpiv_tpu.ops import peakfit as jpeak
from torchpiv_tpu.ops import windows as jwin
from torchpiv_tpu_torch.ops.correlate import (correlate_fft, mean_normalize,
                                              min_subtract, rpc_filter)
from torchpiv_tpu_torch.ops.infill import (fill_missing_values, fused_infill,
                                           interpolate_borders)
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


def _peaked_maps(d=16, n=24, seed=8):
    """Correlation-like maps: a tilted elliptical Gaussian peak at a random
    sub-pixel position over noise, and a weaker second peak elsewhere; the
    corner cases of ``_maps`` ride along."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:d, :d]
    maps = []
    for _ in range(n):
        cy, cx = rng.uniform(3, d - 4, 2)
        sy, sx, t = rng.uniform(0.8, 1.6), rng.uniform(0.8, 1.6), rng.uniform(-0.6, 0.6)
        m = np.exp(-(((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2
                     + t * (yy - cy) * (xx - cx)))
        qy, qx = rng.uniform(2, d - 3, 2)
        m += rng.uniform(0.3, 0.95) * np.exp(-((yy - qy) ** 2 + (xx - qx) ** 2) / 1.5)
        maps.append(m + rng.uniform(0, 0.02, (d, d)))
    return np.concatenate([np.stack(maps).astype(np.float32), _maps(d)])


@pytest.mark.parametrize("min_sub", [False, True])
@pytest.mark.parametrize("validate", [False, True])
def test_gauss2d_fit_matches_jax(min_sub, validate):
    maps = _peaked_maps()
    if min_sub:
        maps = maps * 40.0 - 7.0
    tu, tv, ti = correlation_to_displacement(
        torch.from_numpy(maps), validate, 1.2, 3, min_subtract=min_sub, fit="gauss2d")
    ju, jv, ji = jpeak.correlation_to_displacement(
        jnp.asarray(maps), validate, 1.2, 3, min_subtract=min_sub, fit="gauss2d")
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    if validate:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the cross term is live: the fit differs from gauss3 on tilted peaks
    gu, gv, _ = correlation_to_displacement(
        torch.from_numpy(maps), validate, 1.2, 3, min_subtract=min_sub)
    assert (tu[:24] - gu[:24]).abs().max() > 1e-3
    assert (tu[:24] - gu[:24]).abs().max() < 0.5


@pytest.mark.parametrize("fit", ["gauss3", "gauss2d"])
@pytest.mark.parametrize("min_sub", [False, True])
def test_second_peak_candidates_match_jax(fit, min_sub):
    maps = _peaked_maps(seed=12)
    if min_sub:
        maps = maps * 40.0 - 7.0
    tu, tv, ti, (tu2, tv2) = correlation_to_displacement(
        torch.from_numpy(maps), True, 1.2, 3, min_subtract=min_sub, fit=fit,
        return_second=True)
    ju, jv, ji, (ju2, jv2) = jpeak.correlation_to_displacement(
        jnp.asarray(maps), True, 1.2, 3, min_subtract=min_sub, fit=fit,
        return_second=True)
    for got, want in ((tu, ju), (tv, jv), (tu2, ju2), (tv2, jv2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the candidate is another peak, and the first fit is what it is without it
    assert ((tu2 - tu).abs() + (tv2 - tv).abs())[:24].min() > 1.0
    pu, pv, pi = correlation_to_displacement(
        torch.from_numpy(maps), True, 1.2, 3, min_subtract=min_sub, fit=fit)
    assert torch.equal(pu, tu) and torch.equal(pv, tv) and torch.equal(pi, ti)


def test_peakfit_rejects_second_peak_without_validation_and_unknown_fit():
    maps = torch.from_numpy(_maps())
    with pytest.raises(ValueError, match="return_second"):
        correlation_to_displacement(maps, False, return_second=True)
    with pytest.raises(ValueError, match="return_second"):
        jpeak.correlation_to_displacement(jnp.asarray(_maps()), False, return_second=True)
    with pytest.raises(ValueError, match="fit"):
        correlation_to_displacement(maps, True, fit="centroid")


@pytest.mark.parametrize("n,diameter", [(16, 2.8), (32, 2.8), (64, 4.0), (24, 1.5)])
def test_rpc_filter_exact(n, diameter):
    got = rpc_filter(n, diameter)
    want = np.asarray(jcorr.rpc_filter(n, diameter))
    assert got.shape == (n, n // 2 + 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [16, 32])
def test_rpc_correlation_matches_jax(w):
    rng = np.random.default_rng(10)
    a = rng.uniform(1, 255, (2, 6, w, w)).astype(np.float32)
    b = np.roll(a, (2, -3), axis=(-2, -1)) + rng.normal(0, 2, a.shape).astype(np.float32)
    a[0, 0] = b[0, 0] = 7.0  # a uniform window: structurally zero bins stay zero
    pf = rpc_filter(w)
    got = correlate_fft(torch.from_numpy(a), torch.from_numpy(b), True,
                        phase_filter=pf).numpy()
    want = np.asarray(jcorr.correlate_fft(jnp.asarray(a), jnp.asarray(b), True,
                                          phase_filter=jcorr.rpc_filter(w)))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # the peak sits at the shift, whatever the windows' brightness
    peak = np.unravel_index(got[1, 2].argmax(), (w, w))
    assert peak == (w // 2 + 2, w // 2 - 3)
    scaled = correlate_fft(torch.from_numpy(a * 3), torch.from_numpy(b * 3),
                           phase_filter=pf).numpy()
    np.testing.assert_allclose(scaled[1:], got[1:], rtol=0, atol=1e-5 * np.abs(got).max())


def test_mean_normalize_matches_jax():
    rng = np.random.default_rng(11)
    a = rng.uniform(1, 255, (3, 5, 16, 16)).astype(np.float32)
    got = mean_normalize(torch.from_numpy(a)).numpy()
    want = np.asarray(jcorr.mean_normalize(jnp.asarray(a), jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.mean(axis=(-2, -1)), 1.0, rtol=1e-5)
    # what pass 1 folds into the spectrum product, written out
    folded = correlate_fft(torch.from_numpy(a), torch.from_numpy(a[::-1].copy()), True)
    explicit = correlate_fft(mean_normalize(torch.from_numpy(a)),
                             mean_normalize(torch.from_numpy(a[::-1].copy())))
    assert (folded - explicit).abs().max() <= 1e-4 * explicit.abs().max()


@pytest.mark.parametrize("seed,frac,shape,iters", [
    (0, 0.1, (12, 15), None), (1, 0.3, (12, 15), None), (2, 0.6, (9, 9), None),
    (3, 0.2, (20, 7), 5), (4, 0.0, (6, 6), None)])
def test_fused_infill_matches_jax(seed, frac, shape, iters):
    f = np.stack([_holey_field(seed + 10 * b, frac, shape) for b in range(3)]).astype(np.float32)
    f[2, :, :3] = np.nan  # a pair with a hole the others do not have
    inval = np.isnan(f)
    got = fused_infill(torch.from_numpy(f), torch.from_numpy(inval), iters).numpy()
    assert np.isfinite(got).all() or iters is not None
    for b in range(3):
        want = np.asarray(jinfill.fused_infill(jnp.asarray(f[b]), jnp.asarray(inval[b]), iters))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-4, equal_nan=True)
        np.testing.assert_array_equal(got[b][~inval[b]], f[b][~inval[b]])
    one = fused_infill(torch.from_numpy(f[1]), torch.from_numpy(inval[1]), iters).numpy()
    np.testing.assert_array_equal(one, got[1])


def test_fused_infill_with_nothing_valid_gives_zeros():
    f = np.full((5, 6), np.nan, np.float32)
    got = fused_infill(torch.from_numpy(f), torch.from_numpy(np.isnan(f))).numpy()
    want = np.asarray(jinfill.fused_infill(jnp.asarray(f), jnp.asarray(np.isnan(f))))
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()
