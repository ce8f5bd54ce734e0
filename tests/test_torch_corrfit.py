"""The correlate-and-fit slice of the port on the CPU: the lane-packed
layout, the packed output of the window shift and the plain version of the
correlate-and-fit kernel against the JAX functions they replace
(``pack_windows``, ``shift_windows_pallas(packed=True)`` and
``correlate_peakfit_pallas`` in interpret mode), the step model of the
kernel's transform against both, the CPU path and argument checks of the
kernel's wrapper, and the build's handling of shared headers.
The kernel itself is held against its plain version on a card in
``test_torch_cuda.py``.

Tolerances: layouts and integer shifts must match bit for bit; fractional
shifts may differ by 1e-4 of a grey level (XLA's CPU backend may contract
the blend's multiply-adds); fields: equal masks and RMS < 1e-4 px on valid
windows, the limit the JAX package holds its own kernel to (the plain
version correlates through ``torch.fft``, the TPU kernel through DFT-matrix
products); the step model, a third float32 transform: masks differ on at
most 0.1% of the windows, the same peak cell on at least 99.9% of the
jointly valid ones, and there RMS < 1e-4 px and 1e-3 px at most."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.experimental.fused_pass import correlate_peakfit_pallas
from torchpiv_tpu.experimental.fused_pass import pack_windows as jax_pack_windows
from torchpiv_tpu.kernels.shift_pallas import shift_windows_pallas
from torchpiv_tpu.ops.windows import extract_windows as jax_extract_windows
from torchpiv_tpu_torch.kernels import _build
from torchpiv_tpu_torch.kernels.corrfit import correlate_peakfit, twiddles
from torchpiv_tpu_torch.kernels.shift import shift_windows
from torchpiv_tpu_torch.ops.corrfit import (PLANS, correlate_fit_steps,
                                            correlate_peakfit_reference,
                                            corrfit_supported, twiddle_table)
from torchpiv_tpu_torch.ops.packing import (pack_windows, packed_width,
                                            unpack_windows)
from torchpiv_tpu_torch.ops.windows import extract_windows
from torchpiv_tpu_torch.utils.synthetic import particle_pair


def _grid(shape, w, o):
    return (shape[0] - w) // (w - o) + 1, (shape[1] - w) // (w - o) + 1


def _rms(a, b, sel):
    return float(np.sqrt(np.mean((np.asarray(a)[sel] - np.asarray(b)[sel]) ** 2)))


# (n_rows, n_cols, w): tails of 3, 1 and 0 windows, and one window a group
@pytest.mark.parametrize("n_rows,n_cols,w", [(3, 5, 16), (2, 7, 32), (4, 3, 64),
                                             (2, 8, 32), (2, 3, 128), (1, 33, 4)])
def test_pack_windows_matches_jax(n_rows, n_cols, w):
    rng = np.random.default_rng(w)
    win = rng.uniform(0, 255, (n_rows * n_cols, w, w)).astype(np.float32)
    want = np.asarray(jax_pack_windows(jnp.asarray(win), n_rows, n_cols, w))
    got = pack_windows(torch.from_numpy(win), n_rows, n_cols, w)
    assert got.shape == (n_rows, w, packed_width(n_cols, w)) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    # a leading batch axis packs each item; unpacking drops the tail
    both = pack_windows(torch.from_numpy(np.stack([win, win[::-1]])), n_rows, n_cols, w)
    assert torch.equal(both[0], got)
    assert torch.equal(unpack_windows(both, n_cols, w)[1], torch.from_numpy(win[::-1].copy()))


def test_packed_width_rejects_windows_beyond_128():
    assert packed_width(5, 32) == 8 * 32 and packed_width(4, 32) == 4 * 32
    with pytest.raises(ValueError):
        packed_width(3, 256)


@pytest.mark.parametrize("kind", ["integer", "fractional"])
@pytest.mark.parametrize("shape,w,o", [((128, 112), 32, 16), ((96, 88), 16, 8)])
def test_packed_shift_matches_pallas_kernel(shape, w, o, kind):
    n_rows, n_cols = _grid(shape, w, o)
    assert n_cols % (128 // w)  # a tail to fill
    rng = np.random.default_rng(w)
    frame = rng.uniform(0, 255, shape).astype(np.float32)
    vx = rng.uniform(-w, w, n_rows * n_cols).astype(np.float32)  # past +-S
    vy = rng.uniform(-w, w, n_rows * n_cols).astype(np.float32)
    if kind == "integer":
        vx, vy = np.round(vx), np.round(vy)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    want = np.asarray(shift_windows_pallas(
        jnp.asarray(frame), jnp.asarray(vx), jnp.asarray(vy), packed=True,
        interpret=True, **kw))
    args = [torch.from_numpy(a) for a in (frame, vx, vy)]
    got = shift_windows(*args, packed=True, **kw)
    assert got.shape == want.shape == (n_rows, w, packed_width(n_cols, w))
    if kind == "integer":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the packed output is the standard one, repacked
    assert torch.equal(got, pack_windows(shift_windows(*args, **kw), n_rows, n_cols, w))
    with pytest.raises(ValueError):
        shift_windows(*args, packed=True, interp="bicubic", **kw)


def _jax_corrfit(aa, bb, n_rows, n_cols, w, **kw):
    pa = jax_pack_windows(jnp.asarray(aa), n_rows, n_cols, w)
    pb = jax_pack_windows(jnp.asarray(bb), n_rows, n_cols, w)
    return correlate_peakfit_pallas(pa, pb, wind_size=w, n_cols=n_cols,
                                    interpret=True, **kw)


CASES = {
    "w32": ((128, 128), 32, 16, False, 3),
    "w64-dc-odd-cols": ((192, 128), 64, 32, True, 5),
    "w16-odd-cols": ((96, 88), 16, 8, False, 7),
}


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_kernel(case):
    shape, w, o, dc, seed = CASES[case]
    n_rows, n_cols = _grid(shape, w, o)
    fa, fb = particle_pair(shape, (2.3, -1.2), seed=seed)
    aa = np.asarray(jax_extract_windows(jnp.asarray(fa), w, o), np.float32)
    bb = np.asarray(jax_extract_windows(jnp.asarray(fb), w, o), np.float32)
    np.testing.assert_array_equal(
        extract_windows(torch.from_numpy(fa).float(), w, o).numpy(), aa)
    ju, jv, ji = (np.asarray(t) for t in _jax_corrfit(
        aa, bb, n_rows, n_cols, w, dc_normalize=dc))
    u, v, inval = correlate_peakfit_reference(
        torch.from_numpy(aa), torch.from_numpy(bb), True, 1.2, 3, dc)
    assert u.shape == v.shape == inval.shape == (n_rows * n_cols,)
    assert inval.dtype == torch.bool
    np.testing.assert_array_equal(inval.numpy(), ji)
    assert (~ji).mean() > 0.8
    assert _rms(u, ju, ~ji) < 1e-4 and _rms(v, jv, ~ji) < 1e-4
    assert abs(np.median(u.numpy()[~ji]) - 2.3) < 0.2


@pytest.mark.parametrize("val_ratio,window", [(1.05, 1), (2.0, 3), (1.5, 5)])
def test_plain_version_validation_options_match_pallas_kernel(val_ratio, window):
    shape, w, o = (128, 128), 32, 16
    n_rows, n_cols = _grid(shape, w, o)
    fa, fb = particle_pair(shape, (2.3, -1.2), density=0.01, seed=11)
    aa = extract_windows(torch.from_numpy(fa).float(), w, o)
    bb = extract_windows(torch.from_numpy(fb).float(), w, o)
    _, _, ji = _jax_corrfit(aa.numpy(), bb.numpy(), n_rows, n_cols, w,
                            val_ratio=val_ratio, validation_window=window)
    _, _, inval = correlate_peakfit_reference(aa, bb, True, val_ratio, window)
    np.testing.assert_array_equal(inval.numpy(), np.asarray(ji))


def test_validate_false_returns_no_mask():
    fa, fb = particle_pair((96, 96), (1.0, 0.5), seed=2)
    aa = extract_windows(torch.from_numpy(fa).float(), 32, 16)
    bb = extract_windows(torch.from_numpy(fb).float(), 32, 16)
    u, v, inval = correlate_peakfit_reference(aa, bb, validate=False)
    assert inval is None and torch.isfinite(u).all() and torch.isfinite(v).all()
    ju, _, ji = _jax_corrfit(aa.numpy(), bb.numpy(), 5, 5, 32, validate=False)
    assert ji is None
    assert _rms(u, ju, slice(None)) < 1e-4


def test_eps_is_added_after_the_minimum():
    """A lone bright pixel correlates to a lone peak on a floor of zeros:
    ``(x - min) + EPS`` leaves EPS on the floor samples, so the logs stay
    finite and the fit is centred."""
    w = 16
    a = torch.zeros(1, w, w)
    a[0, 5, 6] = 1.0
    u, v, inval = correlate_peakfit_reference(a, a)
    assert u.item() == 0.0 and v.item() == 0.0 and not inval.item()


def _assert_fit_agrees(got, want):
    (gu, gv, gi), (wu, wv, wi) = [[np.asarray(t) for t in r] for r in (got, want)]
    assert (gi != wi).mean() <= 1e-3
    both = ~(gi | wi)
    du, dv = (gu - wu)[both], (gv - wv)[both]
    same = (np.abs(du) < 0.5) & (np.abs(dv) < 0.5)
    assert 1.0 - same.mean() <= 1e-3
    d = np.concatenate([du[same], dv[same]])
    assert np.sqrt(np.mean(d ** 2)) < 1e-4 and np.abs(d).max() < 1e-3


def _step_case(w):
    """A frame pair with a displacement that scales with the window, cut
    into half-overlapping windows: ``(aa, bb, n_rows, n_cols)``.  The seeds
    leave no 4 or 8 px window whose three-point fit is ill-conditioned:
    there any two float32 transforms, the plain version's and the TPU
    kernel's too, differ by more than the tolerance."""
    shape = (4 * w + w // 2, 5 * w)
    fa, fb = particle_pair(shape, (0.11 * w / 4, -0.07 * w / 4),
                           density=max(0.03, 0.6 / w), seed=48 + w)
    o = w // 2
    aa = extract_windows(torch.from_numpy(fa).float(), w, o)
    bb = extract_windows(torch.from_numpy(fb).float(), w, o)
    return (aa, bb) + _grid(shape, w, o)


@pytest.mark.parametrize("dc", [False, True], ids=["raw", "dc"])
@pytest.mark.parametrize("w", [4, 8, 16, 32, 64, 128])
def test_step_model_matches_plain_version(w, dc):
    aa, bb, n_rows, n_cols = _step_case(w)
    got = correlate_fit_steps(aa, bb, True, 1.2, 3, dc)
    want = correlate_peakfit_reference(aa, bb, True, 1.2, 3, dc)
    assert got[0].shape == (n_rows * n_cols,) and got[2].dtype == torch.bool
    _assert_fit_agrees(got, want)
    nu, nv, ni = correlate_fit_steps(aa, bb, False, 1.2, 3, dc)
    assert ni is None and torch.equal(nu, got[0]) and torch.equal(nv, got[1])


@pytest.mark.parametrize("dc", [False, True], ids=["raw", "dc"])
@pytest.mark.parametrize("w", [4, 8, 16, 32, 64])
def test_step_model_matches_pallas_kernel(w, dc):
    aa, bb, n_rows, n_cols = _step_case(w)
    want = _jax_corrfit(aa.numpy(), bb.numpy(), n_rows, n_cols, w, dc_normalize=dc)
    _assert_fit_agrees(correlate_fit_steps(aa, bb, True, 1.2, 3, dc), want)


def test_step_model_plans_are_the_kernel_headers():
    """``PLANS`` repeats ``Plan<W>`` of ``csrc/corrfit.cuh``: one entry per
    supported window, ``W = P * L``, radices the header's."""
    header = (_build.CSRC / "corrfit.cuh").read_text()
    found = {int(w): (int(p), int(l)) for w, p, l in re.findall(
        r"struct Plan<(\d+)> \{ static constexpr int P = (\d+), L = (\d+),", header)}
    assert found == PLANS
    assert sorted(PLANS) == [w for w in range(1, 300) if corrfit_supported(w)]
    assert all(p * l == w and p % 2 == 0 for w, (p, l) in PLANS.items())


@pytest.mark.parametrize("w", [4, 16, 64, 128])
def test_step_model_finds_a_lone_pixel_pair(w):
    """A lone pixel in each window correlates to a lone peak at the offset
    between the two, so every index map of the transform is right.  The
    floor around the peak is rounding noise, which the three-point fit
    turns into up to half a pixel: the peak cell is what is held."""
    a = torch.zeros(3, w, w)
    b = torch.zeros(3, w, w)
    offsets = [(1, -1), (0, 1), (-1, 1)]  # rows, columns
    for i, (r, c) in enumerate([(1, 2), (w // 2, w // 2), (w - 2, 0)]):
        a[i, r, c] = 3.0
        b[i, r + offsets[i][0], c + offsets[i][1]] = 2.0
    for fit in (correlate_fit_steps, correlate_peakfit_reference):
        u, v, _ = fit(a, b)
        for i, (dr, dc) in enumerate(offsets):
            assert abs(u[i].item() - dc) <= 0.5 and abs(v[i].item() - dr) <= 0.5


def test_wrapper_takes_plain_version_on_cpu():
    fa, fb = particle_pair((96, 96), (1.0, 0.5), seed=4)
    aa = extract_windows(torch.from_numpy(fa).float(), 32, 16)
    bb = extract_windows(torch.from_numpy(fb).float(), 32, 16)
    before = correlate_peakfit.launches
    got = correlate_peakfit(aa, bb, True, 1.3, 2, True)
    assert correlate_peakfit.launches == before  # no kernel on the CPU
    want = correlate_peakfit_reference(aa, bb, True, 1.3, 2, True)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("bad", [
    lambda a, b: (a[0], b[0]),  # not [N, w, w]
    lambda a, b: (a[:, :, :-1], b[:, :, :-1]),  # not square
    lambda a, b: (a, b[:-1]),  # shapes differ
    lambda a, b: (a.double(), b.double()),
    lambda a, b: (a[:, :24, :24], b[:, :24, :24]),  # 24 is not a power of two
    lambda a, b: (a[:, :2, :2], b[:, :2, :2]),  # below 4
], ids=["rank", "square", "shapes", "dtype", "power-of-two", "small"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros(6, 32, 32)
    with pytest.raises(ValueError):
        correlate_peakfit(*bad(a, a.clone()))


def test_supported_windows_are_the_jax_rule():
    ok = [w for w in range(1, 300) if corrfit_supported(w)]
    assert ok == [4, 8, 16, 32, 64, 128]


@pytest.mark.parametrize("w", [4, 32, 128])
def test_twiddle_table_is_the_rounded_float64_table(w):
    j = np.arange(w // 2)
    want = np.stack([np.cos(2 * np.pi * j / w), -np.sin(2 * np.pi * j / w)], axis=1)
    got = twiddles(w, torch.device("cpu"))
    assert got.dtype == torch.float32 and got.shape == (w // 2, 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    # the kernels read it in host memory and pass it on as a parameter
    assert got.device.type == "cpu" and got.is_contiguous()
    assert torch.equal(got, twiddle_table(w))


def test_an_edited_header_changes_every_target(tmp_path, monkeypatch):
    (tmp_path / "one.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "two.cu").write_text("// no include\n")
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.sources() == ["one", "two"]  # headers are not built alone
    before = [_build._target(n).name for n in ("one", "two")]
    assert before == [_build._target(n).name for n in ("one", "two")]
    (tmp_path / "shared.cuh").write_text("// v2\n")
    after = [_build._target(n).name for n in ("one", "two")]
    assert all(a != b for a, b in zip(after, before))
    (tmp_path / "one.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build._target("one").name != after[0]
    assert _build._target("two").name == after[1]


def test_fused_kernels_share_their_device_code_and_call_no_library():
    src = {p.name: p.read_text() for p in _build.CSRC.iterdir()}
    assert '#include "corrfit.cuh"' in src["corrfit.cu"]
    assert '#include "corrfit.cuh"' in src["fused_pass.cu"]
    assert '#include "shift.cuh"' in src["fused_pass.cu"]
    assert '#include "shift.cuh"' in src["shift_windows.cu"]
    assert '#include "fit.cuh"' in src["peakfit.cu"]
    assert '#include "fit.cuh"' in src["corrfit.cuh"]
    for name, text in src.items():
        for lib in ("cufft", "cublas", "cutlass", "cudnn"):
            assert f"#include <{lib}" not in text.lower(), (name, lib)
            assert f'#include "{lib}' not in text.lower(), (name, lib)
