"""The port's MultipassPIV on the CPU against the JAX engine running the
interpreted Pallas kernels (shift, bicubic shift, deformation, peak fit: the
semantics the TPU paths run), and against the float64 golden mirror: the
pass modes, the four shift variants in CWS, DWS and under ``fused="split"``,
and the robust-correlation and validation knobs one by one and together,
with a region-of-interest mask.  Budget (the port's parity budget): less
than 2% validation-mask mismatch and RMS < 0.01 px on jointly valid
vectors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu.utils.synthetic import particle_pair as jax_particle_pair
from torchpiv_tpu.utils.synthetic import shear_flow as jax_shear_flow
from torchpiv_tpu_torch import MultipassPIV, PIVConfig
from torchpiv_tpu_torch.utils.device import check_no_tf32
from torchpiv_tpu_torch.utils.synthetic import particle_pair, shear_flow

SHAPE = (256, 256)


def _rms(a, b, valid):
    d = np.asarray(a, np.float64)[valid] - np.asarray(b, np.float64)[valid]
    return float(np.sqrt(np.mean(d ** 2)))


def _assert_parity(u, v, inval, ru, rv, rinval):
    assert np.mean(inval != rinval) < 0.02
    both = ~(inval | rinval)
    assert both.mean() > 0.5
    assert _rms(u, ru, both) < 0.01
    assert _rms(v, rv, both) < 0.01


def _run_port(cfg_kw, fa, fb):
    eng = MultipassPIV(PIVConfig(**cfg_kw), device="cpu")
    u, v, inval = eng(torch.from_numpy(fa), torch.from_numpy(fb))
    return u.numpy(), v.numpy(), inval.numpy()


@pytest.mark.parametrize("mode", ["CWS", "DWS"])
def test_engine_matches_jax_engine_with_pallas_shift(mode):
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=7)
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2,
              multipass_mode=mode)
    ju, jv, ji = (np.asarray(a) for a in JaxMultipassPIV(
        JaxPIVConfig(**kw, use_pallas="off", pallas_interpret=True))(
            jnp.asarray(fa), jnp.asarray(fb)))
    u, v, inval = _run_port(kw, fa, fb)
    assert u.shape == ju.shape == (15, 15)
    _assert_parity(u, v, inval, ju, jv, ji)


NEW_PATHS = [
    dict(multipass_mode="DEF"),
    dict(multipass_mode="DEF", cws_interp="bicubic"),
    dict(multipass_mode="CWS", cws_interp="bicubic"),
    dict(multipass_mode="CWS", peakfit="pallas"),
    dict(multipass_mode="DEF", peakfit="pallas", def_margin=4),
]


@pytest.mark.parametrize("flow", ["uniform", "shear"])
@pytest.mark.parametrize("extra", NEW_PATHS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_engine_new_paths_match_jax_engine(extra, flow):
    disp = (3.3, -2.1) if flow == "uniform" else shear_flow(1.0, 0.03)
    fa, fb = particle_pair(SHAPE, disp, seed=7)
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2, **extra)
    ju, jv, ji = (np.asarray(a) for a in JaxMultipassPIV(
        JaxPIVConfig(**kw, use_pallas="off", pallas_interpret=True))(
            jnp.asarray(fa), jnp.asarray(fb)))
    u, v, inval = _run_port(kw, fa, fb)
    assert u.shape == ju.shape == (15, 15)
    _assert_parity(u, v, inval, ju, jv, ji)


def test_def_beats_cws_on_shear():
    """Window deformation removes the gradient bias of pure translation:
    DEF's shear RMS stays below 0.75 of CWS's (the JAX package pins the same
    claim for its engine)."""
    shape, du_dy = (512, 512), 0.03
    fa, fb = particle_pair(shape, shear_flow(1.0, du_dy), density=0.04, seed=400)
    rms = {}
    for mode in ("CWS", "DEF"):
        eng = MultipassPIV(PIVConfig(frame_shape=shape, wind_size=64, overlap=32,
                                     multipass=2, multipass_mode=mode), device="cpu")
        u, _, inval = (t.numpy() for t in eng(torch.from_numpy(fa), torch.from_numpy(fb)))
        _, y = eng.final_coordinates
        sel = ~inval
        sel[:3] = sel[-3:] = False
        sel[:, :3] = sel[:, -3:] = False
        rms[mode] = float(np.sqrt(np.mean((u[sel] - (1.0 + du_dy * y[sel])) ** 2)))
    assert rms["DEF"] < 0.045, rms
    assert rms["DEF"] < 0.75 * rms["CWS"], rms


def test_gradient_is_the_jax_gradient():
    from torchpiv_tpu_torch.models.multipass import _gradient

    f = np.random.default_rng(5).normal(size=(2, 7, 9)).astype(np.float32)
    for dim, axis in ((-2, 1), (-1, 2)):
        want = np.asarray(jnp.gradient(jnp.asarray(f), 16.0, axis=axis))
        np.testing.assert_array_equal(_gradient(torch.from_numpy(f), 16.0, dim).numpy(), want)


@pytest.mark.parametrize("multipass,mode", [(1, "CWS"), (2, "CWS"), (2, "DWS"), (3, "CWS")])
def test_engine_matches_golden(multipass, mode):
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=7)
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=multipass,
              multipass_mode=mode)
    gu, gv, x, y, gval = golden.first_pass(fa, fb, 64, 32, True, 1.2)
    it = golden.cws_iteration if mode == "CWS" else golden.dws_iteration
    for w, o in golden.pass_schedule(64, 32, multipass, 2.0)[1:]:
        gu, gv, x, y, gval = it(fa, fb, x, y, gu, gv, gval, w, o)
    u, v, inval = _run_port(kw, fa, fb)
    _assert_parity(u, v, inval, gu, gv, gval)


def test_synthetic_pair_is_the_jax_copy():
    for a, b in zip(particle_pair((64, 80), (1.5, -0.5), seed=3),
                    jax_particle_pair((64, 80), (1.5, -0.5), seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(particle_pair((64, 80), shear_flow(1.0, 0.02), seed=3),
                    jax_particle_pair((64, 80), jax_shear_flow(1.0, 0.02), seed=3)):
        np.testing.assert_array_equal(a, b)


def test_batch_axis_equals_per_pair_runs():
    pairs = [particle_pair((128, 128), d, seed=s)
             for s, d in ((1, (2.0, 1.0)), (2, (-1.5, 0.5)))]
    eng = MultipassPIV(PIVConfig(frame_shape=(128, 128), wind_size=32, overlap=16,
                                 multipass=2), device="cpu")
    fa = torch.from_numpy(np.stack([p[0] for p in pairs]))
    fb = torch.from_numpy(np.stack([p[1] for p in pairs]))
    bu, bv, bi = eng(fa, fb)
    assert bu.shape == (2, *eng.final_field_shape)
    for i in range(2):
        u, v, inval = eng(fa[i], fb[i])
        torch.testing.assert_close(u, bu[i], rtol=0, atol=1e-5)
        torch.testing.assert_close(v, bv[i], rtol=0, atol=1e-5)
        assert torch.equal(inval, bi[i])


@pytest.mark.parametrize("fused", ["split", "on"])
def test_fused_modes_recover_the_displacement_and_count_no_launch_on_cpu(fused):
    from torchpiv_tpu_torch.kernels import KERNELS

    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=7)
    before = [k.launches for k in KERNELS]
    u, v, inval = _run_port(dict(frame_shape=SHAPE, wind_size=64, overlap=32,
                                 multipass=2, fused=fused), fa, fb)
    assert [k.launches for k in KERNELS] == before
    assert inval.mean() < 0.05
    assert abs(u[2:-2, 2:-2].mean() - 3.3) < 0.05
    assert abs(v[2:-2, 2:-2].mean() + 2.1) < 0.05


def test_validate_false_gives_no_invalid_field():
    fa, fb = particle_pair((128, 128), (2.0, 1.0), seed=4)
    eng = MultipassPIV(PIVConfig(frame_shape=(128, 128), wind_size=32, overlap=16,
                                 multipass=2, validate=False), device="cpu")
    u, v, inval = eng(torch.from_numpy(fa), torch.from_numpy(fb))
    assert inval is None and torch.isfinite(u).all() and torch.isfinite(v).all()


def test_engine_rejects_frames_of_another_shape():
    eng = MultipassPIV(PIVConfig(frame_shape=(128, 128), wind_size=32, overlap=16),
                       device="cpu")
    with pytest.raises(ValueError):
        eng(torch.zeros(96, 128), torch.zeros(96, 128))


def test_tf32_is_refused_on_cuda(monkeypatch):
    check_no_tf32(torch.device("cpu"))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        check_no_tf32(torch.device("cuda"))
    check_no_tf32(torch.device("cpu"))  # the CPU path has no TF32


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultipassPIV(PIVConfig(frame_shape=(128, 128), wind_size=32, overlap=16))


def _run_jax(cfg_kw, fa, fb, **engine_kw):
    eng = JaxMultipassPIV(JaxPIVConfig(**cfg_kw, use_pallas="off",
                                       pallas_interpret=True), **engine_kw)
    u, v, inval = eng(jnp.asarray(fa), jnp.asarray(fb))
    return eng, np.asarray(u), np.asarray(v), None if inval is None else np.asarray(inval)


@pytest.mark.parametrize("path", [
    dict(multipass_mode="CWS"), dict(multipass_mode="DWS"),
    dict(multipass_mode="CWS", fused="split")],
    ids=["CWS", "DWS", "split"])
@pytest.mark.parametrize("variant", ["bf16", "lanephases", "mxu", "phases"])
def test_engine_shift_variants_match_jax_engine(variant, path):
    """The knob reaches the refine pass on every path that reads it; on 8-bit
    frames every variant gives the ``rolls`` fields bit for bit."""
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=7)
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2, **path)
    _, ju, jv, ji = _run_jax(dict(kw, shift_variant=variant), fa, fb)
    u, v, inval = _run_port(dict(kw, shift_variant=variant), fa, fb)
    _assert_parity(u, v, inval, ju, jv, ji)
    ru, rv, ri = _run_port(kw, fa, fb)
    np.testing.assert_array_equal(u, ru)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(inval, ri)


@pytest.mark.parametrize("variant", ["bf16", "lanephases", "mxu", "phases"])
def test_engine_shift_variant_on_float_frames(variant, monkeypatch):
    """Frames whose values are not exact in bfloat16: the bfloat16 variants
    change the refine pass's windows (and stay within the parity budget of
    the JAX engine, which rounds alike); ``lanephases`` does not."""
    from torchpiv_tpu_torch.models import multipass as mp

    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=7)
    fa = fa.astype(np.float32) * 0.731 + 0.37
    fb = fb.astype(np.float32) * 0.731 + 0.37
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2,
              shift_variant=variant)
    seen = []
    real = mp.shift_windows

    def spy(*a, **k):
        seen.append(k.get("variant"))
        return real(*a, **k)

    monkeypatch.setattr(mp, "shift_windows", spy)
    u, v, inval = _run_port(kw, fa, fb)
    assert seen == [variant, variant]
    _, ju, jv, ji = _run_jax(kw, fa, fb)
    _assert_parity(u, v, inval, ju, jv, ji)
    ru, rv, _ = _run_port(dict(kw, shift_variant="rolls"), fa, fb)
    same = np.array_equal(u, ru) and np.array_equal(v, rv)
    assert same == (variant == "lanephases")


@pytest.mark.parametrize("extra", [
    dict(fused="on"), dict(multipass_mode="DEF")], ids=["fused_on", "DEF"])
def test_engine_paths_that_ignore_the_shift_variant(extra, monkeypatch):
    from torchpiv_tpu_torch.models import multipass as mp

    def refuse(*a, **k):
        raise AssertionError("shift_windows is not on this path")

    monkeypatch.setattr(mp, "shift_windows", refuse)
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=7)
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2, **extra)
    u, v, inval = _run_port(dict(kw, shift_variant="phases"), fa, fb)
    ru, rv, ri = _run_port(kw, fa, fb)
    np.testing.assert_array_equal(u, ru)
    np.testing.assert_array_equal(inval, ri)


def _rough_pair(seed=7, disp=(3.3, -2.1)):
    """A recording with trouble in it: a particle-free patch, a glare patch
    that does not move, and a few patches of uncorrelated noise in frame b;
    all written from the seed."""
    fa, fb = particle_pair(SHAPE, disp, seed=seed)
    fa, fb = fa.copy(), fb.copy()
    rng = np.random.default_rng(seed + 100)
    fa[:60, :60] = 8
    fb[:60, :60] = 8
    fa[150:200, 30:90] = np.maximum(fa[150:200, 30:90], 200)
    fb[150:200, 30:90] = np.maximum(fb[150:200, 30:90], 200)
    for _ in range(4):
        r, c = rng.integers(0, SHAPE[0] - 40, 2)
        fb[r:r + 40, c:c + 40] = rng.integers(0, 256, (40, 40))
    return fa, fb


ROBUST_KNOBS = [
    dict(window_weight="gaussian"),
    dict(correlation="rpc"),
    dict(correlation="rpc", window_weight="gaussian", rpc_diameter=3.5),
    dict(subpixel="gauss2d"),
    dict(median_filter="median"),
    dict(median_filter="normmedian", median_threshold=1.5),
    dict(u_limits=(2.5, 4.0)),
    dict(v_limits=(-2.5, -1.5)),
    dict(global_std=2.0),
    dict(second_peak_fallback=True),
    dict(second_peak_fallback=True, median_filter="normmedian", u_limits=(-1.0, 6.0)),
    dict(second_peak_fallback=True, multipass=1),
    dict(window_weight="gaussian", multipass=1),
    dict(validate=False, median_filter="normmedian"),
    dict(multipass_mode="DWS", window_weight="gaussian", subpixel="gauss2d"),
    dict(multipass_mode="DEF", correlation="rpc", median_filter="median"),
]


@pytest.mark.parametrize("extra", ROBUST_KNOBS,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_engine_robust_knobs_match_jax_engine(extra):
    fa, fb = _rough_pair()
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2)
    kw.update(extra)
    _, ju, jv, ji = _run_jax(kw, fa, fb)
    u, v, inval = _run_port(kw, fa, fb)
    assert u.shape == ju.shape
    _assert_parity(u, v, inval, ju, jv, ji)
    assert inval.any()  # the trouble shows


@pytest.mark.parametrize("extra", [
    dict(), dict(multipass_mode="DWS"), dict(median_filter="normmedian"),
    dict(second_peak_fallback=True, global_std=3.0)],
    ids=lambda kw: "-".join(map(str, kw.values())) or "plain")
def test_engine_fused_infill_matches_jax_engine(extra):
    """``infill="fused"`` fills every invalid vector on the device: finite
    fields, equal to the JAX engine's within the budget at every site, the
    filled ones included."""
    fa, fb = _rough_pair()
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2,
              infill="fused", **extra)
    _, ju, jv, ji = _run_jax(kw, fa, fb)
    u, v, inval = _run_port(kw, fa, fb)
    assert np.isfinite(u).all() and np.isfinite(v).all() and inval.any()
    _assert_parity(u, v, inval, ju, jv, ji)
    same = inval == ji
    everywhere = np.ones_like(inval)
    if same.all():
        assert _rms(u, ju, everywhere) < 0.01 and _rms(v, jv, everywhere) < 0.01
    # the valid vectors are untouched by the fill
    pu, pv, pi = _run_port(dict(kw, infill="none"), fa, fb)
    np.testing.assert_array_equal(pi, inval)
    np.testing.assert_array_equal(u[~inval], pu[~inval])
    np.testing.assert_array_equal(v[~inval], pv[~inval])


def _roi_mask():
    mask = np.zeros(SHAPE, bool)
    mask[:, :48] = True  # a wall along the left edge
    mask[180:, 150:230] = True  # a model surface
    return mask


@pytest.mark.parametrize("extra,threshold", [
    (dict(), 0.5), (dict(), 0.0), (dict(multipass_mode="DWS"), 0.25),
    (dict(multipass_mode="DEF"), 0.5), (dict(validate=False), 0.5),
    (dict(multipass=1), 0.5), (dict(fused="split"), 0.5), (dict(fused="on"), 0.5),
    (dict(global_std=3.0, median_filter="median"), 0.5)],
    ids=lambda x: "-".join(map(str, x.values())) if isinstance(x, dict) else str(x))
def test_engine_frame_mask_matches_jax_engine(extra, threshold):
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=7)
    mask = _roi_mask()
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2)
    kw.update(extra)
    jeng, ju, jv, ji = _run_jax(kw, fa, fb, frame_mask=mask, mask_threshold=threshold)
    eng = MultipassPIV(PIVConfig(**kw), device="cpu", frame_mask=mask,
                       mask_threshold=threshold)
    u, v, inval = (t.numpy() for t in eng(torch.from_numpy(fa), torch.from_numpy(fb)))
    _assert_parity(u, v, inval, ju, jv, ji)
    masked = eng.window_masked[-1].numpy()
    np.testing.assert_array_equal(masked, jeng.window_masked[-1])
    assert masked.any() and not masked.all()
    assert inval[masked].all() and (u[masked] == 0).all() and (v[masked] == 0).all()
    # away from the mask the flow is recovered (windows that straddle the
    # mask's edge see zeroed pixels and are biased: the median passes them by)
    clear = ~masked & ~inval
    assert abs(np.median(u[clear]) - 3.3) < 0.05
    assert abs(np.median(v[clear]) + 2.1) < 0.05


ROBUST = dict(median_filter="normmedian", u_limits=(-8.0, 8.0), v_limits=(-8.0, 8.0),
              global_std=5.0, second_peak_fallback=True)


@pytest.mark.parametrize("extra", [
    dict(shift_variant="phases"),
    dict(shift_variant="bf16", multipass_mode="DWS"),
    dict(correlation="rpc", window_weight="gaussian"),
    dict(subpixel="gauss2d", infill="fused"),
    dict(multipass=3, shift_variant="mxu", infill="fused"),
], ids=lambda kw: "-".join(map(str, kw.values())))
def test_engine_robust_configuration_matches_jax_engine(extra):
    """Everything a user turns on for a real recording, at once: the mask,
    the global filters, the median filter, the fallback, a shift variant."""
    fa, fb = _rough_pair()
    mask = _roi_mask()
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2, **ROBUST)
    kw.update(extra)
    jeng, ju, jv, ji = _run_jax(kw, fa, fb, frame_mask=mask)
    eng = MultipassPIV(PIVConfig(**kw), device="cpu", frame_mask=mask)
    u, v, inval = (t.numpy() for t in eng(torch.from_numpy(fa), torch.from_numpy(fb)))
    _assert_parity(u, v, inval, ju, jv, ji)
    masked = eng.window_masked[-1].numpy()
    assert inval[masked].all()
    if kw.get("infill") != "fused":
        assert (u[masked] == 0).all() and (v[masked] == 0).all()
    else:
        assert np.isfinite(u).all() and np.isfinite(v).all()


def test_second_peak_fallback_rescues_vectors_per_pair():
    """The fallback only ever clears invalid flags, never at masked windows,
    and a pair's result does not depend on its batch neighbours."""
    pairs = [_rough_pair(seed=s) for s in (7, 8)]
    mask = _roi_mask()
    kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2,
              median_filter="normmedian")
    fa = torch.from_numpy(np.stack([p[0] for p in pairs]))
    fb = torch.from_numpy(np.stack([p[1] for p in pairs]))
    plain = MultipassPIV(PIVConfig(**kw), device="cpu", frame_mask=mask)
    eng = MultipassPIV(PIVConfig(**kw, second_peak_fallback=True), device="cpu",
                       frame_mask=mask)
    _, _, pi = plain(fa, fb)
    bu, bv, bi = eng(fa, fb)
    assert not (bi & ~pi).any() and (pi & ~bi).any()
    assert bi[:, eng.window_masked[-1]].all()
    for i in range(2):
        u, v, inval = eng(fa[i], fb[i])
        assert torch.equal(inval, bi[i])
        torch.testing.assert_close(u, bu[i], rtol=0, atol=1e-5)
        torch.testing.assert_close(v, bv[i], rtol=0, atol=1e-5)
