"""The port's ``ops/filters.py``, ``ops/sad.py`` and ``ops/particles.py`` on
the CPU against the JAX package's, on the same seeded inputs.

Tolerances (measured on these inputs in brackets): ``gaussian_blur`` max
abs <= 1e-5 * max|x| [1.5e-7]; ``fast_sad`` <= 1e-5 [1.4e-6]; ``sad_fft``
<= 1e-4 relative to the map's largest magnitude [2.4e-7], NaN where a
window is blank in both; ``detect_particles``
the same valid set, positions <= 1e-4 px [1.9e-6], responses <= 1e-5
relative [1.1e-7]."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.ops import filters as jax_filters
from torchpiv_tpu.ops import particles as jax_particles
from torchpiv_tpu.ops import sad as jax_sad
from torchpiv_tpu_torch.ops import filters, particles, sad
from torchpiv_tpu_torch.utils.synthetic import particle_pair, render_particles


def _frame(xs, ys, shape=(128, 160), inten=180.0, noise=1.5, seed=0):
    rng = np.random.default_rng(seed)
    f = render_particles(shape, np.asarray(xs), np.asarray(ys),
                         np.full(len(xs), inten), diameter=3.0)
    f = f + rng.normal(0, noise, shape).astype(np.float32) + 8.0
    return np.clip(f, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("sigma,truncate", [(1.0, 3.0), (1.3, 3.0), (1.0, 2.5), (0.4, 3.0),
                                            (2.2, 2.0)])
@pytest.mark.parametrize("shape", [(37, 53), (3, 64, 48)])
def test_gaussian_blur_matches_jax(sigma, truncate, shape):
    x = np.random.default_rng(0).random(shape).astype(np.float32) * 200
    got = filters.gaussian_blur(torch.from_numpy(x), sigma, truncate).numpy()
    assert got.shape == shape and got.dtype == np.float32
    frames = x.reshape(-1, *shape[-2:])
    want = np.stack([np.asarray(jax_filters.gaussian_blur(jnp.asarray(f), sigma, truncate))
                     for f in frames]).reshape(shape)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("sigma,truncate", [(1.0, 3.0), (1.3, 2.5), (0.2, 3.0), (2.2, 2.0)])
def test_gaussian_taps_are_the_jax_taps(sigma, truncate):
    """The JAX package's numpy taps (``ops/filters.py``), within float32
    rounding: 2e-7 [measured 0 to 3e-8]."""
    r = max(1, int(np.ceil(truncate * sigma)))
    span = np.arange(-r, r + 1, dtype=np.float32)
    want = np.exp(-(span**2) / (2.0 * sigma * sigma))
    want = want / want.sum()
    k = filters.gaussian_taps(sigma, truncate).numpy()
    assert k.dtype == np.float32 and k.shape == want.shape
    assert np.abs(k - want).max() <= 2e-7


def _windows(seed, n=20, w=16):
    rng = np.random.default_rng(seed)
    wa = rng.integers(0, 255, (n, w, w)).astype(np.uint8)
    wb = np.roll(wa, (2, -3), axis=(1, 2)) // 2 + rng.integers(0, 60, (n, w, w)).astype(np.uint8)
    wa[3] = 7  # a blank window: 0/0 = NaN in both packages
    return wa, wb


@pytest.mark.parametrize("w", [8, 16, 32])
def test_batch_normalize_matches_jax(w):
    wa, _ = _windows(1, w=w)
    got = sad.batch_normalize(torch.from_numpy(wa)).numpy()
    want = np.asarray(jax_sad.batch_normalize(jnp.asarray(wa)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.nanmax(np.abs(got - want)) <= 1e-6


@pytest.mark.parametrize("w", [8, 16, 32])
def test_fast_sad_matches_jax(w):
    wa, wb = _windows(2, w=w)
    got = sad.fast_sad(torch.from_numpy(wa), torch.from_numpy(wb))
    want = jax_sad.fast_sad(jnp.asarray(wa), jnp.asarray(wb))
    for g, j in zip(got, want):
        g, j = g.numpy(), np.asarray(j)
        assert g.shape == j.shape == (len(wa), w + 1)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(j))
        assert np.nanmax(np.abs(g - j)) <= 1e-5


@pytest.mark.parametrize("p", [1, 3, 5])
@pytest.mark.parametrize("w", [16, 32])
def test_sad_fft_matches_jax(p, w):
    wa, wb = _windows(3, w=w)
    got = sad.sad_fft(torch.from_numpy(wa), torch.from_numpy(wb), p).numpy()
    want = np.asarray(jax_sad.sad_fft(jnp.asarray(wa), jnp.asarray(wb), p))
    assert got.shape == want.shape == wa.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    # the map sums w^2 products (about 1000 at w32, where one float32 ulp is
    # 1.2e-4): the bound is relative to its largest magnitude
    assert np.nanmax(np.abs(got - want)) <= 1e-4 * np.nanmax(np.abs(want))


def test_sad_extrema_locate_the_displacement():
    """On a particle pair displaced by (3, -2) px, ``fast_sad``'s curves are
    least at the placements ``w/2 - u`` and ``w/2 - v``, and ``sad_fft``'s
    accumulated map (the cosine/sine correlation) is largest at the
    displacement from the centre."""
    fa, fb = particle_pair((64, 64), (3.0, -2.0), density=0.05, seed=1)
    wa = torch.from_numpy(fa[None, 16:48, 16:48].copy())
    wb = torch.from_numpy(fb[None, 16:48, 16:48].copy())
    sx, sy = sad.fast_sad(wa, wb)
    assert (int(sx[0].argmin()), int(sy[0].argmin())) == (16 - 3, 16 + 2)
    r, c = np.unravel_index(int(sad.sad_fft(wa, wb)[0].argmax()), (32, 32))
    assert (c - 16, r - 16) == (3, -2)


def _detections(out):
    """Valid detections as rows ``(y, x, response)`` sorted by ``(y, x)``."""
    xs, ys, resp, valid = (np.asarray(a) for a in out)
    rows = np.stack([ys[valid], xs[valid], resp[valid]], axis=1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def _same_detections(got, want):
    g, w = _detections(got), _detections(want)
    assert len(g) == len(w)
    np.testing.assert_array_equal(np.rint(g[:, :2]), np.rint(w[:, :2]))
    assert np.abs(g[:, :2] - w[:, :2]).max(initial=0.0) <= 1e-4
    assert (np.abs(g[:, 2] - w[:, 2]) <= 1e-5 * np.abs(w[:, 2])).all()


@pytest.mark.parametrize("density", [0.004, 0.01, 0.03])
@pytest.mark.parametrize("min_distance,smooth_sigma,n_sigma",
                         [(3, 1.3, 4.0), (2, 1.0, 3.0), (4, 0.8, 5.0)])
def test_detect_particles_matches_jax(density, min_distance, smooth_sigma, n_sigma):
    fa, _ = particle_pair((128, 160), (2.3, -1.2), density=density, seed=3)
    kw = dict(n_sigma=n_sigma, smooth_sigma=smooth_sigma)
    got = particles.detect_particles(torch.from_numpy(fa), 512, min_distance, **kw)
    want = jax_particles.detect_particles(jnp.asarray(fa), 512, min_distance, **kw)
    assert all(t.shape == (512,) for t in got)
    assert got[3].any()
    _same_detections(got, want)


def test_detect_particles_batch_is_per_frame():
    """The batch axis replaces ``vmap``: each frame its own threshold."""
    fa, fb = particle_pair((128, 160), (2.3, -1.2), density=0.01, seed=5)
    fb = (fb // 2).astype(np.uint8)  # a dimmer frame, another threshold
    both = particles.detect_particles(torch.from_numpy(np.stack([fa, fb])), 256, 3)
    assert all(t.shape == (2, 256) for t in both)
    for i, f in enumerate((fa, fb)):
        _same_detections([t[i] for t in both],
                         jax_particles.detect_particles(jnp.asarray(f), 256, 3))


def test_detect_particles_threshold_and_borders():
    """An absolute threshold, and particles on the border rows and columns
    (the stencil clamped to the interior), as in the JAX package."""
    xs = [0.3, 159.6, 80.2, 40.0, 120.7]
    ys = [60.0, 20.4, 0.2, 127.5, 64.3]
    f = _frame(xs, ys)
    for thr in (None, 40.0):
        got = particles.detect_particles(torch.from_numpy(f), 32, 3, threshold=thr)
        want = jax_particles.detect_particles(
            jnp.asarray(f), 32, 3, threshold=None if thr is None else jnp.float32(thr))
        _same_detections(got, want)


@pytest.mark.parametrize("val", [0, 37])
def test_detect_blank_frame_no_detections(val):
    f = np.full((64, 64), val, dtype=np.uint8)
    assert not particles.detect_particles(torch.from_numpy(f), 32, 3)[3].any()


def test_detect_saturated_plateau_single_detection():
    f = _frame([100.0], [80.0], inten=3000.0, noise=0.0)
    assert (f == 255).sum() >= 4
    xs, ys, _, valid = particles.detect_particles(torch.from_numpy(f), 16, 3)
    assert int(valid.sum()) == 1
    assert abs(float(xs[0]) - 100.0) < 0.5 and abs(float(ys[0]) - 80.0) < 0.5
