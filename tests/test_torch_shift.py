"""The window shift: the port's plain version against the TPU kernel it
replaces (``shift_windows_pallas`` in interpret mode), the CPU path of the
CUDA kernel's wrapper and the kernel's argument checks.  The kernel itself
is held against its plain version on a card in ``test_torch_cuda.py``.

Tolerances: integer shifts are copies and must match bit for bit;
fractional bilinear shifts may differ by 1e-4 of a grey level and bicubic
ones by 1e-3, because XLA's CPU backend may contract the multiply-adds of
the blend and of the cubic weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.kernels.shift_pallas import flat_wrap_pad as jax_flat_wrap_pad
from torchpiv_tpu.kernels.shift_pallas import shift_windows_pallas
from torchpiv_tpu_torch.kernels import KERNELS, _build
from torchpiv_tpu_torch.kernels.shift import shift_windows, shift_windows_bicubic
from torchpiv_tpu_torch.ops.shifts import flat_wrap_pad, shift_windows_reference


@pytest.mark.parametrize("shape,P", [((16, 24), 3), ((40, 33), 8), ((64, 96), 16)])
def test_flat_wrap_pad_exact(shape, P):
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 255, (2, *shape)).astype(np.float32)
    got = flat_wrap_pad(torch.from_numpy(frames), P).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(jax_flat_wrap_pad(jnp.asarray(frames[b]), P)))


def _case(shape, w, o, kind, seed):
    rng = np.random.default_rng(seed)
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    frame = rng.uniform(0, 255, shape).astype(np.float32)
    reach = 1.5 * w  # past the +-S = w/2 clamp
    vx = rng.uniform(-reach, reach, n).astype(np.float32)
    vy = rng.uniform(-reach, reach, n).astype(np.float32)
    if kind == "integer":
        vx, vy = np.round(vx), np.round(vy)
    elif kind == "mixed":  # integer in one axis: the floor corner
        vx = np.round(vx)
    return frame, vx, vy


@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed"])
@pytest.mark.parametrize("shape,w,o", [((64, 96), 16, 8), ((128, 128), 32, 16)])
def test_plain_version_matches_pallas_kernel(shape, w, o, kind):
    frame, vx, vy = _case(shape, w, o, kind, seed=w)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    want = np.asarray(shift_windows_pallas(
        jnp.asarray(frame), jnp.asarray(vx), jnp.asarray(vy), interpret=True, **kw))
    got = shift_windows_reference(
        torch.from_numpy(frame), torch.from_numpy(vx), torch.from_numpy(vy), **kw).numpy()
    assert got.shape == want.shape
    if kind == "fractional":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed"])
@pytest.mark.parametrize("shape,w,o", [((64, 96), 16, 8), ((128, 128), 32, 16)])
def test_plain_bicubic_version_matches_pallas_kernel(shape, w, o, kind):
    frame, vx, vy = _case(shape, w, o, kind, seed=w + 1)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, interp="bicubic")
    want = np.asarray(shift_windows_pallas(
        jnp.asarray(frame), jnp.asarray(vx), jnp.asarray(vy), interpret=True, **kw))
    got = shift_windows_reference(
        torch.from_numpy(frame), torch.from_numpy(vx), torch.from_numpy(vy), **kw).numpy()
    assert got.shape == want.shape
    if kind == "integer":  # weights (0, 1, 0, 0): the integer copy
        np.testing.assert_array_equal(got, want)
        bilinear = shift_windows_reference(
            torch.from_numpy(frame), torch.from_numpy(vx), torch.from_numpy(vy),
            **dict(kw, interp="bilinear")).numpy()
        np.testing.assert_array_equal(got, bilinear)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kw", [dict(flat_wrap=False), dict(max_shift=5)])
def test_plain_bicubic_version_options_match_pallas_kernel(kw):
    shape, w, o = (64, 96), 16, 8
    frame, vx, vy = _case(shape, w, o, "fractional", seed=5)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, interp="bicubic", **kw)
    want = np.asarray(shift_windows_pallas(
        jnp.asarray(frame), jnp.asarray(vx), jnp.asarray(vy), interpret=True, **kw))
    got = shift_windows_reference(
        torch.from_numpy(frame), torch.from_numpy(vx), torch.from_numpy(vy), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kw", [dict(flat_wrap=False), dict(max_shift=5)])
def test_plain_version_options_match_pallas_kernel(kw):
    shape, w, o = (64, 96), 16, 8
    frame, vx, vy = _case(shape, w, o, "integer", seed=3)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, **kw)
    want = np.asarray(shift_windows_pallas(
        jnp.asarray(frame), jnp.asarray(vx), jnp.asarray(vy), interpret=True, **kw))
    got = shift_windows_reference(
        torch.from_numpy(frame), torch.from_numpy(vx), torch.from_numpy(vy), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_takes_plain_version_on_cpu():
    shape, w, o = (64, 96), 16, 8
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    cases = [_case(shape, w, o, "fractional", seed=s) for s in (1, 2)]
    frames = torch.from_numpy(np.stack([c[0] for c in cases]))
    vx = torch.from_numpy(np.stack([c[1] for c in cases]))
    vy = torch.from_numpy(np.stack([c[2] for c in cases]))
    before = shift_windows.launches
    batched = shift_windows(frames, vx, vy, **kw)
    assert shift_windows.launches == before  # no kernel on the CPU
    assert batched.shape == (2, vx.shape[1], w, w) and batched.dtype == torch.float32
    for b in range(2):
        single = shift_windows(frames[b], vx[b], vy[b], **kw)
        assert torch.equal(single, batched[b])
        assert torch.equal(single, shift_windows_reference(frames[b], vx[b], vy[b], **kw))


def test_bicubic_wrapper_takes_plain_version_on_cpu():
    shape, w, o = (64, 96), 16, 8
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    frame, vx, vy = (torch.from_numpy(a) for a in _case(shape, w, o, "fractional", 4))
    before = shift_windows_bicubic.launches, shift_windows.launches
    got = shift_windows_bicubic(frame, vx, vy, **kw)
    assert (shift_windows_bicubic.launches, shift_windows.launches) == before
    assert torch.equal(got, shift_windows(frame, vx, vy, interp="bicubic", **kw))
    assert torch.equal(got, shift_windows_reference(frame, vx, vy, interp="bicubic", **kw))
    assert not torch.equal(got, shift_windows(frame, vx, vy, **kw))


@pytest.mark.parametrize("bad", [
    dict(wind_size=130, overlap=2), dict(out_dtype=torch.bfloat16),
    dict(wind_size=126, overlap=2, interp="bicubic"), dict(interp="lanczos")])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    kw = dict(frame_shape=(256, 256), wind_size=32, overlap=16)
    kw.update(bad)
    frame = torch.zeros(256, 256)
    with pytest.raises(ValueError):
        shift_windows(frame, torch.zeros(225), torch.zeros(225), **kw)


def test_wrapper_rejects_wrong_map_shape():
    with pytest.raises(ValueError):
        shift_windows(torch.zeros(64, 64), torch.zeros(5), torch.zeros(5),
                      frame_shape=(64, 64), wind_size=16, overlap=8)


def test_kernel_sources_are_in_the_package():
    names = ["corrfit", "def_windows", "fused_pass", "peakfit", "shift_windows",
             "shift_windows_bf16", "shift_windows_bicubic",
             "shift_windows_lanephases", "shift_windows_mxu", "shift_windows_phases"]
    assert _build.sources() == names
    wrappers = {"correlate_peakfit": "corrfit", "fused_piv_pass": "fused_pass"}
    assert sorted(wrappers.get(k.__name__, k.__name__) for k in KERNELS) == names
    assert all(isinstance(k.launches, int) for k in KERNELS)
    for name in names:
        target = _build._target(name)
        assert target.parent == _build.BUILD_DIR and target.suffix == ".so"
