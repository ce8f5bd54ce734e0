"""The port's MultipassPIV on the CPU against the JAX engine running the
interpreted Pallas kernels (shift, bicubic shift, deformation, peak fit: the
semantics the TPU paths run), and against the float64 golden mirror.  Budget (the port's parity budget): less
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
