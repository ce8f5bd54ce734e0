"""The pass-fusion paths of the port on the CPU: the plain version of the
whole-pass kernel against ``fused_piv_pass`` in interpret mode, and the
2-pass engine with ``fused="split"`` and ``fused="on"`` against the JAX
engine in the same mode (its Pallas kernels interpreted), with the
fallbacks to the unfused chain.

Tolerances: kernel level, equal masks and RMS < 1e-4 px on valid windows;
engine level, masks equal on at least 99% of the windows and RMS < 1e-3 px
on jointly valid ones: the limits of the JAX package's own tests of these
kernels (``tests/test_fused_pass.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.experimental.fused_pass import fused_piv_pass as jax_fused_piv_pass
from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu_torch import MultipassPIV, PIVConfig
from torchpiv_tpu_torch.kernels import KERNELS
from torchpiv_tpu_torch.kernels.corrfit import correlate_peakfit
from torchpiv_tpu_torch.kernels.fused_pass import fused_piv_pass
from torchpiv_tpu_torch.kernels.shift import shift_windows
from torchpiv_tpu_torch.ops.corrfit import fused_pass_reference
from torchpiv_tpu_torch.utils.synthetic import particle_pair, shear_flow

FS = (128, 112)
W, O = 32, 16
N = ((FS[0] - W) // (W - O) + 1) * ((FS[1] - W) // (W - O) + 1)


def _rms(a, b, sel):
    return float(np.sqrt(np.mean((np.asarray(a)[sel] - np.asarray(b)[sel]) ** 2)))


def _shifts(kind):
    rng = np.random.default_rng(1)
    maps = [rng.uniform(-3, 3, N).astype(np.float32) for _ in range(4)]
    if kind == "integer":
        maps = [np.round(m * 4) for m in maps]  # up to +-12 px, inside +-S
    elif kind == "beyond-clamp":
        maps = [m * 8 for m in maps]  # up to +-24 px, past +-S = 16
    return maps


@pytest.mark.parametrize("kind", ["fractional", "integer", "beyond-clamp"])
def test_plain_version_matches_pallas_kernel(kind):
    fa, fb = particle_pair(FS, (2.3, -1.2), seed=3)
    maps = _shifts(kind)
    kw = dict(frame_shape=FS, wind_size=W, overlap=O)
    ju, jv, ji = (np.asarray(t) for t in jax_fused_piv_pass(
        jnp.asarray(fa), jnp.asarray(fb), *map(jnp.asarray, maps),
        interpret=True, **kw))
    u, v, inval = fused_pass_reference(
        torch.from_numpy(fa)[None], torch.from_numpy(fb)[None],
        *(torch.from_numpy(m)[None] for m in maps), **kw)
    assert u.shape == v.shape == inval.shape == (1, N)
    np.testing.assert_array_equal(inval[0].numpy(), ji)
    ok = ~ji
    assert ok.mean() > 0.3  # random shifts of up to 24 px decorrelate many
    assert _rms(u[0], ju, ok) < 1e-4 and _rms(v[0], jv, ok) < 1e-4


def test_plain_version_first_pass_matches_pallas_kernel():
    """Zero shifts with ``dc_normalize``: the first pass, at a window grid
    with an odd number of columns."""
    shape = (192, 128)
    fa, fb = particle_pair(shape, (3.3, -2.1), seed=5)
    n = 5 * 3
    z = np.zeros(n, np.float32)
    kw = dict(frame_shape=shape, wind_size=64, overlap=32, dc_normalize=True)
    ju, jv, ji = (np.asarray(t) for t in jax_fused_piv_pass(
        jnp.asarray(fa), jnp.asarray(fb), z, z, z, z, interpret=True, **kw))
    zt = torch.zeros(1, n)
    u, v, inval = fused_pass_reference(
        torch.from_numpy(fa)[None], torch.from_numpy(fb)[None], zt, zt, zt, zt, **kw)
    np.testing.assert_array_equal(inval[0].numpy(), ji)
    assert _rms(u[0], ju, ~ji) < 1e-4 and _rms(v[0], jv, ~ji) < 1e-4
    assert abs(np.median(u[0].numpy()[~ji]) - 3.3) < 0.2


def test_plain_version_options_match_pallas_kernel():
    fa, fb = particle_pair(FS, (2.3, -1.2), seed=3)
    maps = _shifts("beyond-clamp")
    kw = dict(frame_shape=FS, wind_size=W, overlap=O, max_shift=5, validate=False)
    ju, jv, ji = jax_fused_piv_pass(
        jnp.asarray(fa), jnp.asarray(fb), *map(jnp.asarray, maps),
        interpret=True, **kw)
    u, v, inval = fused_pass_reference(
        torch.from_numpy(fa)[None], torch.from_numpy(fb)[None],
        *(torch.from_numpy(m)[None] for m in maps), **kw)
    assert ji is None and inval is None
    # without validation every window counts, the weakly correlated too
    close = np.abs(u[0].numpy() - np.asarray(ju)) < 0.5
    assert close.mean() > 0.95
    assert _rms(u[0], ju, close) < 1e-3


@pytest.mark.parametrize("kind", ["fractional", "integer"])
def test_wrapper_on_cpu_is_the_shift_then_the_fit(kind):
    """The wrapper's CPU path, batched and single, and the identity the CUDA
    kernels keep bit for bit: the whole pass correlates the windows of
    ``shift_windows``."""
    pairs = [particle_pair(FS, (2.3, -1.2), seed=s) for s in (3, 4)]
    fa = torch.from_numpy(np.stack([p[0] for p in pairs]))
    fb = torch.from_numpy(np.stack([p[1] for p in pairs]))
    maps = [torch.from_numpy(np.stack([m, -m])) for m in _shifts(kind)]
    kw = dict(frame_shape=FS, wind_size=W, overlap=O)
    before = {k.__name__: k.launches for k in KERNELS}
    u, v, inval = fused_piv_pass(fa, fb, *maps, **kw)
    assert {k.__name__: k.launches for k in KERNELS} == before  # no kernel on the CPU
    assert u.shape == (2, N) and inval.dtype == torch.bool
    aa = shift_windows(fa, maps[0], maps[1], **kw)
    bb = shift_windows(fb, maps[2], maps[3], **kw)
    su, sv, si = correlate_peakfit(aa.reshape(-1, W, W), bb.reshape(-1, W, W))
    assert torch.equal(u.reshape(-1), su) and torch.equal(v.reshape(-1), sv)
    assert torch.equal(inval.reshape(-1), si)
    one = fused_piv_pass(fa[1], fb[1], *(m[1] for m in maps), validate=False, **kw)
    assert one[2] is None and one[0].shape == (N,)
    torch.testing.assert_close(one[0], u[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad", [
    dict(wind_size=24, overlap=12), dict(wind_size=256, overlap=128),
    dict(frame_b=torch.zeros(64, 64)), dict(vxa=torch.zeros(3)),
], ids=["power-of-two", "beyond-128", "frames-differ", "map-shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    kw = dict(frame_shape=(512, 512), wind_size=32, overlap=16)
    n = 31 * 31
    args = dict(frame_a=torch.zeros(512, 512), frame_b=torch.zeros(512, 512),
                vxa=torch.zeros(n), vya=torch.zeros(n), vxb=torch.zeros(n),
                vyb=torch.zeros(n))
    for k, val in bad.items():
        (args if k in args else kw)[k] = val
    with pytest.raises(ValueError):
        fused_piv_pass(*args.values(), **kw)


SHAPE = (256, 256)
BASE = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2)

ENGINE_MODES = [
    dict(fused="split", multipass_mode="CWS"),
    dict(fused="split", multipass_mode="DWS"),
    dict(fused="split", multipass_mode="DEF"),
    dict(fused="split", multipass_mode="CWS", cws_interp="bicubic"),
    dict(fused="on", multipass_mode="CWS"),
    dict(fused="on", multipass_mode="DWS"),
    dict(fused="on", multipass_mode="DEF"),  # pass 1 fuses, DEF ignores "on"
]


def _port(kw, fa, fb):
    eng = MultipassPIV(PIVConfig(**kw), device="cpu")
    return tuple(t.numpy() for t in eng(torch.from_numpy(fa), torch.from_numpy(fb)))


@pytest.mark.parametrize("extra", ENGINE_MODES, ids=lambda kw: "-".join(kw.values()))
def test_engine_matches_jax_engine_in_the_same_mode(extra):
    flow = shear_flow(1.0, 0.03) if extra["multipass_mode"] == "DEF" else (3.3, -2.1)
    fa, fb = particle_pair(SHAPE, flow, seed=7)
    kw = dict(BASE, **extra)
    jeng = JaxMultipassPIV(JaxPIVConfig(**kw, use_pallas="off", pallas_interpret=True))
    teng = MultipassPIV(PIVConfig(**kw), device="cpu")
    assert teng._use_split() == jeng._use_split()
    assert teng._use_fused() == jeng._use_fused()
    assert teng._use_split() or teng._use_fused()
    ju, jv, ji = (np.asarray(a) for a in jeng(jnp.asarray(fa), jnp.asarray(fb)))
    u, v, inval = (t.numpy() for t in teng(torch.from_numpy(fa), torch.from_numpy(fb)))
    assert u.shape == ju.shape == (15, 15)
    agree = inval == ji
    assert agree.mean() >= 0.99
    both = ~(inval | ji)
    assert both.mean() > 0.9
    assert _rms(u, ju, both) < 1e-3 and _rms(v, jv, both) < 1e-3


@pytest.mark.parametrize("extra", [
    dict(fused="split", wind_size=40, overlap=20),  # not a power of two
    dict(fused="split", wind_size=96, overlap=48),  # pass 2 (48 px) is not
    dict(fused="on", edge_exact=False),
    dict(fused="on", cws_interp="bicubic"),
    dict(fused="on", wind_size=48, overlap=24),
    dict(fused="auto"), dict(fused="off"),
], ids=lambda kw: "-".join(map(str, kw.values())))
def test_where_fusion_does_not_apply_the_unfused_chain_runs(extra):
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=9)
    kw = dict(BASE, **extra)
    eng = MultipassPIV(PIVConfig(**kw), device="cpu")
    assert not eng._use_split() and not eng._use_fused()
    if extra.get("wind_size") != 48:  # the JAX "on" predicate ignores the size
        jeng = JaxMultipassPIV(JaxPIVConfig(**kw))
        assert not jeng._use_split() and not jeng._use_fused()
    got = _port(kw, fa, fb)
    want = _port(dict(kw, fused="off"), fa, fb)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("fused", ["split", "on"])
def test_fused_engine_stays_within_the_budget_of_the_unfused_one(fused):
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=7)
    u, v, inval = _port(dict(BASE, fused=fused), fa, fb)
    ru, rv, ri = _port(BASE, fa, fb)
    assert np.mean(inval != ri) < 0.02
    both = ~(inval | ri)
    assert _rms(u, ru, both) < 0.01 and _rms(v, rv, both) < 0.01
    assert not np.array_equal(u, ru)  # another arithmetic did run


@pytest.mark.parametrize("fused", ["split", "on"])
def test_fused_engine_without_validation_and_over_a_batch(fused):
    pairs = [particle_pair((128, 128), d, seed=s)
             for s, d in ((1, (2.0, 1.0)), (2, (-1.5, 0.5)))]
    eng = MultipassPIV(PIVConfig(frame_shape=(128, 128), wind_size=32, overlap=16,
                                 multipass=2, validate=False, fused=fused),
                       device="cpu")
    fa = torch.from_numpy(np.stack([p[0] for p in pairs]))
    fb = torch.from_numpy(np.stack([p[1] for p in pairs]))
    bu, bv, bi = eng(fa, fb)
    assert bi is None and bu.shape == (2, *eng.final_field_shape)
    assert torch.isfinite(bu).all() and torch.isfinite(bv).all()
    for i in range(2):
        u, v, inval = eng(fa[i], fb[i])
        assert inval is None
        torch.testing.assert_close(u, bu[i], rtol=0, atol=1e-5)
        torch.testing.assert_close(v, bv[i], rtol=0, atol=1e-5)
