"""The port's PIVConfig twin and the static engine state against the JAX
engine: validation, pass schedules, field shapes, coordinates, window
origins and spline upsample matrices (exact), the JAX-config conversion,
and a ValueError for every knob that is not ported yet."""
import dataclasses

import numpy as np
import pytest

from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu_torch import MultipassPIV, PIVConfig
from torchpiv_tpu_torch.state import from_jax_config

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


NOT_PORTED = [
    dict(multipass_mode="DEF"),
    dict(cws_interp="bicubic"),
    dict(peakfit="pallas"),
    dict(fused="split"),
    dict(fused="on"),
    dict(window_weight="gaussian"),
    dict(correlation="rpc"),
    dict(subpixel="gauss2d"),
    dict(infill="fused"),
    dict(median_filter="median"),
    dict(u_limits=(-5.0, 5.0)),
    dict(v_limits=(-5.0, 5.0)),
    dict(global_std=3.0),
    dict(second_peak_fallback=True),
]


@pytest.mark.parametrize("kw", NOT_PORTED)
def test_unported_knobs_raise_naming_the_knob(kw):
    JaxPIVConfig(frame_shape=FRAME, **kw)  # valid for the JAX engine
    (knob,) = kw
    with pytest.raises(ValueError, match=knob):
        PIVConfig(frame_shape=FRAME, **kw)
    with pytest.raises(ValueError, match=knob):
        from_jax_config(dataclasses.asdict(JaxPIVConfig(frame_shape=FRAME, **kw)))


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
