"""Window deformation (DEF): the port's plain version against the TPU kernel
it replaces (``def_windows_pallas`` in interpret mode), the CPU path of the
CUDA kernel's wrapper and the kernel's argument checks.  The kernel itself
is held against its plain version on a card in ``test_torch_cuda.py``.

Tolerances: integer centre shifts with zero gradients are tile copies and
must match bit for bit, the bilinear ``shift_windows`` included.  In the
general case at least 99.5% of the pixels agree within 1e-3 of a grey level
and all within 2 grey levels' worth of one cell: XLA's CPU backend may
contract the multiply-adds of the per-pixel residual, which can move a pixel
that sits on an integer coordinate into the neighbouring cell."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.kernels.def_pallas import def_windows_pallas
from torchpiv_tpu_torch.kernels.deform import def_windows
from torchpiv_tpu_torch.kernels.shift import shift_windows
from torchpiv_tpu_torch.ops.deform import def_windows_reference, keys_weight
from torchpiv_tpu_torch.ops.shifts import cubic_weights

SHAPE, W, O = (160, 96), 32, 16  # a 9 x 5 grid: the interpreted kernel unrolls its columns
N = ((SHAPE[0] - W) // (W - O) + 1) * ((SHAPE[1] - W) // (W - O) + 1)


def _case(kind, seed):
    """frame, the centre shifts (vx, vy) and (dudx, dudy, dvdx, dvdy)."""
    rng = np.random.default_rng(seed)
    frame = rng.uniform(0, 255, SHAPE).astype(np.float32)
    reach = 1.5 * W  # past the +-S = w/2 clamp
    vx = rng.uniform(-reach, reach, N).astype(np.float32)
    vy = rng.uniform(-reach, reach, N).astype(np.float32)
    slope = {"general": 0.05, "saturating": 0.6, "integer": 0.0}[kind]
    grads = [rng.uniform(-slope, slope, N).astype(np.float32) for _ in range(4)]
    if kind == "integer":
        vx, vy = np.round(vx), np.round(vy)
    return frame, (vx, vy), grads


def _both(frame, vel, grads, **kw):
    kw = dict(frame_shape=SHAPE, wind_size=W, overlap=O, **kw)
    maps = [*vel, *grads]
    want = np.asarray(def_windows_pallas(
        jnp.asarray(frame), *(jnp.asarray(m) for m in maps), interpret=True, **kw))
    got = def_windows_reference(
        torch.from_numpy(frame), *(torch.from_numpy(m) for m in maps), **kw).numpy()
    assert got.shape == want.shape == (N, W, W)
    return got, want


def _assert_close(got, want):
    d = np.abs(got - want)
    assert (d <= 1e-3).mean() >= 0.995
    assert d.max() <= 255.0  # a moved pixel is still a frame value


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("margin", [1, 2, 4])
def test_plain_version_matches_pallas_kernel(interp, margin):
    got, want = _both(*_case("general", margin), margin=margin, interp=interp)
    _assert_close(got, want)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("flat_wrap", [True, False])
def test_plain_version_flat_wrap_matches_pallas_kernel(interp, flat_wrap):
    got, want = _both(*_case("general", 11), flat_wrap=flat_wrap, interp=interp)
    _assert_close(got, want)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_saturating_gradients_match_pallas_kernel(interp):
    """Gradients of 0.6 px/px reach +-9 px across a 32 px window: far past
    the margin of 2, so most residuals sit at the clip bounds."""
    got, want = _both(*_case("saturating", 12), interp=interp)
    _assert_close(got, want)


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("kw", [dict(), dict(max_shift=5), dict(flat_wrap=False)])
def test_integer_centres_without_gradient_are_exact(interp, kw):
    frame, vel, grads = _case("integer", 13)
    got, want = _both(frame, vel, grads, interp=interp, **kw)
    np.testing.assert_array_equal(got, want)
    # ... and equal the bilinear shift kernel's integer copy.  Windows
    # clipped to +S are left out: there the shift kernel's (w+1) px tile
    # overhangs its S px pad in the last row and column and is clamped back
    # by a pixel, which the DEF pad (one pixel wider) never needs.
    if kw.get("flat_wrap", True):
        S = kw.get("max_shift") or W // 2
        copy = shift_windows(torch.from_numpy(frame), *(torch.from_numpy(v) for v in vel),
                             frame_shape=SHAPE, wind_size=W, overlap=O,
                             max_shift=kw.get("max_shift")).numpy()
        inside = (vel[0] < S) & (vel[1] < S)
        assert 0 < inside.sum() < N
        np.testing.assert_array_equal(got[inside], copy[inside])


def test_wrapper_takes_plain_version_on_cpu():
    cases = [_case("general", s) for s in (1, 2)]
    frames = torch.from_numpy(np.stack([c[0] for c in cases]))
    maps = [torch.from_numpy(np.stack([[*c[1], *c[2]][i] for c in cases]))
            for i in range(6)]
    kw = dict(frame_shape=SHAPE, wind_size=W, overlap=O, interp="bicubic")
    before = def_windows.launches
    batched = def_windows(frames, *maps, **kw)
    assert def_windows.launches == before  # no kernel on the CPU
    assert batched.shape == (2, N, W, W) and batched.dtype == torch.float32
    for b in range(2):
        single = def_windows(frames[b], *(m[b] for m in maps), **kw)
        assert torch.equal(single, batched[b])
        assert torch.equal(single, def_windows_reference(
            frames[b], *(m[b] for m in maps), **kw))


@pytest.mark.parametrize("bad", [
    dict(wind_size=126, overlap=2),  # 126 + 4 + 1 > 129
    dict(wind_size=122, overlap=2, interp="bicubic"),  # 122 + 4 + 4 > 129
    dict(margin=0), dict(interp="lanczos"), dict(out_dtype=torch.bfloat16)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    kw = dict(frame_shape=(256, 256), wind_size=32, overlap=16)
    kw.update(bad)
    z = torch.zeros(225)
    with pytest.raises(ValueError):
        def_windows(torch.zeros(256, 256), z, z, z, z, z, z, **kw)


def test_wrapper_rejects_wrong_map_shape():
    z, short = torch.zeros(49), torch.zeros(5)
    with pytest.raises(ValueError):
        def_windows(torch.zeros(64, 64), z, z, z, short, z, z,
                    frame_shape=(64, 64), wind_size=16, overlap=8)


def test_keys_weights_partition_unity_and_agree():
    """The per-pixel Keys weight of the DEF kernel and the per-window weights
    of the bicubic shift kernel are the same function: the four taps sum to
    one, and integer positions give (0, 1, 0, 0) exactly."""
    t = torch.linspace(0, 1, 33)[:-1]
    w4 = torch.stack(cubic_weights(t))
    torch.testing.assert_close(w4.sum(0), torch.ones_like(t), rtol=0, atol=1e-6)
    per_pixel = torch.stack([keys_weight(t + 1.0 - k) for k in range(4)])
    torch.testing.assert_close(per_pixel, w4, rtol=0, atol=1e-6)
    assert w4[:, 0].tolist() == [0.0, 1.0, 0.0, 0.0]
    assert keys_weight(torch.tensor([2.0, -2.0, 2.5, -3.0])).tolist() == [0.0] * 4
