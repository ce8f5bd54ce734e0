"""The port's PIVConfig twin and the static engine state against the JAX
engine: validation, pass schedules, field shapes, coordinates, window
origins and spline upsample matrices (exact), the JAX-config conversion,
the pass-fusion knob with the combinations both engines refuse, the
robust-correlation and validation knobs, the live ``shift_variant``, the
static region-of-interest state, the ``dtype`` knob (every float type
constructs and carries across; a non-float type, and the FFT correlator on
low-precision pass-1 windows, raise a ValueError naming the knob), and the
configurations that take the JAX engine's XLA paths under ``"auto"``:
refine windows beyond the resampling kernels' limits and bicubic CWS with a
shift variant construct in the port and give the JAX engine's fields (its
XLA path there, even with ``pallas_interpret=True``) within the port's
parity budget (less than 2% validation-mask mismatch, RMS < 0.01 px on
jointly valid vectors)."""
import dataclasses

import numpy as np
import pytest
import torch

from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu_torch import MultipassPIV, PIVConfig
from torchpiv_tpu_torch.config import compute_dtype
from torchpiv_tpu_torch.state import from_jax_config, from_jax_engine_state

FRAME = (192, 256)

# the configurations of tests/test_config_matrix.py that the slice runs
SUPPORTED = [
    dict(multipass_mode=mode, use_pallas=pallas)
    for mode in ("CWS", "DWS") for pallas in ("on", "off")
] + [
    dict(infill="none"),
    dict(correlator="fft", dft_precision="default"),
    dict(correlator="matmul", dft_precision="highest"),
    dict(validate=False),
    dict(edge_exact=False, use_pallas="on"),
    dict(max_shift=8, use_pallas="on"),
    dict(multipass_mode="DEF"),
    dict(multipass_mode="DEF", cws_interp="bicubic", def_margin=4),
    dict(cws_interp="bicubic"),
    dict(peakfit="pallas"),
    dict(fused="split"),
    dict(fused="on"),
    dict(fused="split", multipass_mode="DEF", cws_interp="bicubic"),
    dict(fused="on", multipass_mode="DWS", edge_exact=False),
    # the robust-correlation and validation knobs
    dict(window_weight="gaussian"),
    dict(correlation="rpc"),
    dict(correlation="rpc", rpc_diameter=3.5, window_weight="gaussian"),
    dict(subpixel="gauss2d"),
    dict(infill="fused"),
    dict(median_filter="median"),
    dict(median_filter="normmedian", median_threshold=3.0),
    dict(u_limits=(-5.0, 5.0)),
    dict(v_limits=(-5.0, 5.0)),
    dict(global_std=3.0),
    dict(second_peak_fallback=True),
    dict(second_peak_fallback=True, fallback_threshold=1.5),
    # the shift variants, where the JAX engine runs them
    dict(shift_variant="bf16"),
    dict(shift_variant="lanephases", multipass_mode="DWS"),
    dict(shift_variant="mxu", fused="split"),
    dict(shift_variant="phases", max_shift=8),
    dict(shift_variant="bf16", multipass_mode="DWS", cws_interp="bicubic"),
    dict(shift_variant="phases", multipass_mode="DEF", cws_interp="bicubic"),
]


def _pair(**kw):
    base = dict(frame_shape=FRAME, wind_size=32, overlap=16, multipass=2)
    base.update(kw)
    return JaxPIVConfig(**base), PIVConfig(**base)


@pytest.mark.parametrize("kw", SUPPORTED + [
    dict(multipass=3, multipass_mode="DWS"),
    dict(wind_size=48, overlap=24, multipass=2),
    dict(frame_shape=(2048, 2048), wind_size=64, overlap=32),
])
def test_static_state_matches_jax_engine(kw):
    jcfg, tcfg = _pair(**kw)
    jeng = JaxMultipassPIV(jcfg)
    teng = MultipassPIV(tcfg, device="cpu")
    assert teng.schedule == jeng.schedule == jcfg.pass_schedule()
    assert teng.field_shapes == jeng.field_shapes
    for (tx, ty), (jx, jy) in zip(teng.coords, jeng.coords):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    for (tr, tc), (jr, jc) in zip(teng.origins, jeng.origins):
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tc, jc)
    assert len(teng.upsamplers) == len(jeng.upsamplers)
    for (tay, tax), (jay, jax_) in zip(teng.upsamplers, jeng.upsamplers):
        np.testing.assert_array_equal(tay.numpy(), np.asarray(jay))
        np.testing.assert_array_equal(tax.numpy(), np.asarray(jax_))
    # the static operators are registered buffers
    names = set(dict(teng.named_buffers()))
    assert {"origins_0", "Ay_1", "Ax_1"} <= names


@pytest.mark.parametrize("kw", SUPPORTED)
def test_from_jax_config_round_trip(kw):
    jcfg, tcfg = _pair(**kw)
    got = from_jax_config(dataclasses.asdict(jcfg))
    assert got == tcfg
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)


def test_fields_and_defaults_match_jax_twin():
    jf = {f.name: f.default for f in dataclasses.fields(JaxPIVConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(PIVConfig)}
    assert jf == tf


# values the JAX config takes and the port refuses: element types that are
# no float type (the JAX engine would wrap 8-bit grey levels into int8)
NOT_PORTED = [
    dict(dtype="int8"),
    dict(dtype="float8_e4m3fn"),
]


@pytest.mark.parametrize("kw", NOT_PORTED)
def test_unported_knobs_raise_naming_the_knob(kw):
    JaxPIVConfig(frame_shape=FRAME, **kw)  # valid for the JAX config
    (knob,) = kw
    with pytest.raises(ValueError, match=knob):
        PIVConfig(frame_shape=FRAME, **kw)
    with pytest.raises(ValueError, match=knob):
        from_jax_config(dataclasses.asdict(JaxPIVConfig(frame_shape=FRAME, **kw)))


# dtype -> the element type the port computes in (float64 as the JAX
# package computes it with 64-bit mode off, as these tests run it)
DTYPES = {"float32": torch.float32, "float64": torch.float32,
          "bfloat16": torch.bfloat16, "float16": torch.float16,
          "half": torch.float16}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_every_float_dtype_constructs_and_carries_across(dtype):
    kw = dict(frame_shape=FRAME, wind_size=32, overlap=16, multipass=2, dtype=dtype)
    jcfg, tcfg = JaxPIVConfig(**kw), PIVConfig(**kw)
    assert from_jax_config(dataclasses.asdict(jcfg)) == tcfg
    assert compute_dtype(dtype) == str(DTYPES[dtype]).removeprefix("torch.")
    jeng = JaxMultipassPIV(jcfg)
    teng = MultipassPIV(tcfg, device="cpu")
    assert teng.compute_dtype == DTYPES[dtype]
    # the JAX package's effective type: float64 is float32 with x64 off
    assert {str(a.dtype) for a in jeng.upsamplers[0]} == {compute_dtype(dtype)}
    for t, j in zip(teng.upsamplers[0], jeng.upsamplers[0]):
        assert t.dtype == DTYPES[dtype]
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_fft_correlator_refuses_low_precision_windows_like_jax(dtype):
    """The JAX package's FFT takes float32 and float64 only: its engine
    raises on pass 1's windows when it runs, the port when it is
    configured; where pass 1 runs fused or weighted both take the type."""
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    kw = dict(frame_shape=(64, 64), wind_size=32, overlap=16, dtype=dtype,
              correlator="fft")
    a, b = particle_pair((64, 64), (1.0, 0.5), seed=3)
    with pytest.raises(ValueError, match="float32"):
        JaxMultipassPIV(JaxPIVConfig(**kw))(a, b)
    with pytest.raises(ValueError, match="correlator='fft'"):
        PIVConfig(**kw)
    for ok in (dict(correlator="auto"), dict(correlator="matmul"),
               dict(fused="split"), dict(fused="on"),
               dict(window_weight="gaussian")):
        assert PIVConfig(**{**kw, **ok})


# refine-pass windows beyond the resampling kernels' limits: both engines
# take their XLA path there
BEYOND_KERNEL_LIMITS = [
    # bicubic CWS: pass-2 window 126 > 125
    dict(wind_size=252, overlap=126, cws_interp="bicubic"),
    # DEF bilinear: 126 + 2*2 + 1 = 131 > 129
    dict(wind_size=252, overlap=126, multipass_mode="DEF"),
    # DEF bicubic: 122 + 2*2 + 4 = 130 > 129
    dict(wind_size=244, overlap=122, multipass_mode="DEF", cws_interp="bicubic"),
    # DEF bilinear with a wide margin: 120 + 2*8 + 1 = 137 > 129
    dict(wind_size=240, overlap=120, multipass_mode="DEF", def_margin=8),
]

WITHIN_KERNEL_LIMITS = [
    dict(wind_size=250, overlap=124, cws_interp="bicubic"),  # 125
    dict(wind_size=256, overlap=128, cws_interp="bicubic", multipass_mode="DWS"),
    dict(wind_size=248, overlap=124, multipass_mode="DEF"),  # 124 + 5 = 129
    dict(wind_size=242, overlap=120, multipass_mode="DEF", cws_interp="bicubic"),
]


def _assert_fields_match_jax(kw):
    """The port's engine at ``"auto"`` against the JAX engine with its
    interpreted kernels on one pair: the parity budget."""
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    fa, fb = particle_pair(kw["frame_shape"], (3.3, -2.1), seed=7)
    ju, jv, ji = (np.asarray(a) for a in JaxMultipassPIV(
        JaxPIVConfig(**kw, pallas_interpret=True))(fa, fb))
    u, v, inval = (t.numpy() for t in MultipassPIV(PIVConfig(**kw), device="cpu")(
        torch.from_numpy(fa), torch.from_numpy(fb)))
    assert u.shape == ju.shape
    assert np.mean(inval != ji) < 0.02
    both = ~(inval | ji)
    assert both.mean() > 0.5
    for a, b in ((u, ju), (v, jv)):
        assert np.sqrt(np.mean((a[both] - b[both]).astype(np.float64) ** 2)) < 0.01


@pytest.mark.parametrize("kw", BEYOND_KERNEL_LIMITS)
def test_windows_beyond_the_kernel_limits_match_jax(kw):
    big = dict(frame_shape=(512, 512), multipass=2, **kw)
    assert from_jax_config(dataclasses.asdict(JaxPIVConfig(**big))) == PIVConfig(**big)
    _assert_fields_match_jax(big)


@pytest.mark.parametrize("kw", WITHIN_KERNEL_LIMITS)
def test_windows_at_the_kernel_limits_pass(kw):
    cfg = PIVConfig(frame_shape=(512, 512), multipass=2, **kw)
    assert cfg.pass_schedule()[1][0] == kw["wind_size"] // 2


@pytest.mark.parametrize("kw", [
    dict(peakfit="pallas", second_peak_fallback=True),
    dict(peakfit="pallas", subpixel="gauss2d"),
    dict(fused="on", window_weight="gaussian"),
    dict(fused="split", correlation="rpc"),
    dict(fused="on", correlation="rpc"),
    dict(fused="split", second_peak_fallback=True),
    dict(fused="on", second_peak_fallback=True),
    dict(fused="both"),
])
def test_peakfit_kernel_combinations_raise_like_jax(kw):
    with pytest.raises(ValueError):
        JaxPIVConfig(frame_shape=FRAME, **kw)
    with pytest.raises(ValueError):
        PIVConfig(frame_shape=FRAME, **kw)


def test_only_dtype_is_left_unported():
    """The table is empty: ``dtype`` is ported, and refuses only the
    non-float types (``compute_dtype``)."""
    from torchpiv_tpu_torch.config import NOT_PORTED as table

    assert table == {}
    for dtype in ("int32", "complex64", "no_such_type", None):
        with pytest.raises(ValueError, match="dtype"):
            compute_dtype(dtype)


@pytest.mark.parametrize("variant", ["bf16", "lanephases", "mxu", "phases"])
def test_bicubic_cws_with_a_shift_variant_matches_jax(variant):
    """The JAX engine sends this combination to its XLA bicubic shift; so
    does the port."""
    kw = dict(frame_shape=FRAME, multipass=2, cws_interp="bicubic",
              shift_variant=variant)
    assert from_jax_config(dataclasses.asdict(JaxPIVConfig(**kw))) == PIVConfig(**kw)
    _assert_fields_match_jax(kw)


@pytest.mark.parametrize("variant,runs", [
    ("rolls", "rolls"), ("bf16", "bf16"), ("lanephases", "lanephases"),
    ("mxu", "mxu"), ("phases", "phases"), ("no_such_variant", "rolls")])
def test_shift_variant_is_live(variant, runs):
    """The knob reaches the engine; a name that is none of the five runs
    ``rolls``, as ``shift_windows_pallas`` does for it."""
    cfg = PIVConfig(frame_shape=FRAME, multipass=2, shift_variant=variant)
    assert cfg.shift_variant == variant
    assert MultipassPIV(cfg, device="cpu")._shift_variant() == runs


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.5, 1.0])
def test_mask_state_matches_jax_engine(threshold):
    """Both engines hold the same static state for a region-of-interest
    mask: the mask, the per-pass masked windows, origins and upsamplers."""
    rng = np.random.default_rng(3)
    mask = np.zeros(FRAME, bool)
    mask[:70, 40:130] = True
    mask[150:, 200:] = True
    mask |= rng.uniform(size=FRAME) < 0.02
    jcfg, tcfg = _pair(multipass=3)
    jeng = JaxMultipassPIV(jcfg, frame_mask=mask, mask_threshold=threshold)
    teng = MultipassPIV(tcfg, device="cpu", frame_mask=mask,
                        mask_threshold=threshold)
    want = from_jax_engine_state(jeng)
    assert {"frame_mask", "window_masked_0", "window_masked_2", "origins_1",
            "Ay_2", "Ax_1"} <= set(want)
    have = dict(teng.named_buffers())
    for name, value in want.items():
        assert have[name].dtype == value.dtype, name
        assert np.array_equal(have[name].numpy(), value.numpy()), name
    assert any(m.any() and not m.all() for m in teng.window_masked)
    # the state loads into an engine that was built without the mask's
    # buffers being equal: same names, same shapes
    other = MultipassPIV(tcfg, device="cpu", frame_mask=~mask,
                         mask_threshold=threshold)
    other.load_state_dict(want, strict=False)
    for name, value in want.items():
        assert np.array_equal(dict(other.named_buffers())[name].numpy(), value.numpy())


def test_engine_without_mask_has_no_mask_state():
    jcfg, tcfg = _pair()
    teng = MultipassPIV(tcfg, device="cpu")
    assert teng.frame_mask is None and teng.window_masked == [None, None]
    want = from_jax_engine_state(JaxMultipassPIV(jcfg))
    assert not any(k.startswith(("frame_mask", "window_masked")) for k in want)
    with pytest.raises(ValueError, match="mask_threshold"):
        MultipassPIV(tcfg, device="cpu", frame_mask=np.zeros(FRAME, bool),
                     mask_threshold=1.5)
    with pytest.raises(ValueError, match="frame_mask"):
        MultipassPIV(tcfg, device="cpu", frame_mask=np.zeros((8, 8), bool))


@pytest.mark.parametrize("kw", [
    dict(use_pallas="on"), dict(pallas_interpret=True),
    dict(shift_variant="phases"), dict(shift_maps="prefetch"),
    dict(extract_variant="tilemajor"), dict(complex_mm="gauss"),
    dict(correlator="matmul"), dict(dft_precision="default"),
])
def test_tpu_lowering_knobs_are_accepted(kw):
    ((knob, value),) = kw.items()
    assert getattr(PIVConfig(frame_shape=FRAME, **kw), knob) == value


@pytest.mark.parametrize("kw", [
    dict(overlap=64), dict(wind_size=300), dict(multipass_mode="XYZ"),
    dict(infill="nope"), dict(use_pallas="maybe"), dict(correlator="dft"),
    dict(multipass=6), dict(def_margin=0), dict(shift_maps="all"),
    dict(window_weight="hann"), dict(correlation="phase"),
    dict(correlation="rpc", rpc_diameter=0.0), dict(subpixel="centroid"),
    dict(u_limits=(5.0, -5.0)), dict(v_limits=(1.0,)), dict(global_std=0.0),
    dict(second_peak_fallback=True, validate=False),
    dict(second_peak_fallback=True, fallback_threshold=0.0),
])
def test_invalid_values_raise_like_jax(kw):
    with pytest.raises(ValueError):
        JaxPIVConfig(frame_shape=FRAME, **kw)
    with pytest.raises(ValueError):
        PIVConfig(frame_shape=FRAME, **kw)


def test_from_jax_config_rejects_unknown_fields():
    d = dataclasses.asdict(JaxPIVConfig(frame_shape=FRAME))
    d["not_a_knob"] = 1
    with pytest.raises(ValueError, match="not_a_knob"):
        from_jax_config(d)


@pytest.mark.parametrize("fused", ["split", "on"])
def test_fused_is_ported(fused):
    from torchpiv_tpu_torch.config import NOT_PORTED as table

    assert "fused" not in table
    cfg = PIVConfig(frame_shape=FRAME, fused=fused)
    assert cfg.fused == fused
    jcfg = JaxPIVConfig(frame_shape=FRAME, fused=fused)
    assert from_jax_config(dataclasses.asdict(jcfg)).fused == fused
    # windows of any size construct: where fusion does not apply the engine
    # runs the unfused chain
    assert PIVConfig(frame_shape=FRAME, wind_size=40, overlap=20, fused=fused)
