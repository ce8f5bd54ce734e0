"""The ``dtype`` knob: the port's engine with ``dtype`` ``"bfloat16"``,
``"float16"`` and ``"float64"`` against the JAX engine (running the
interpreted Pallas kernels), in CWS and DEF, on float-valued frames whose
grey levels the low-precision types round.

The JAX engine's FFT correlator refuses low-precision windows, so the JAX
side runs ``correlator="matmul"``, its TPU correlator, which promotes them
to float32 as the port's correlation does.  Tolerance, as in
``test_torch_pipeline.py``: RMS 0.01 px, fewer than 2% of the components
more than 0.01 px apart, and the same invalid windows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu_torch import MultipassPIV, PIVConfig
from torchpiv_tpu_torch.utils.synthetic import particle_pair, shear_flow

SHAPE = (128, 128)


def _frames(mode):
    disp = shear_flow(1.0, 0.01) if mode == "DEF" else (3.3, -2.1)
    fa, fb = particle_pair(SHAPE, disp, seed=5)
    # not 8-bit grey levels: bfloat16 rounds them, float16 too
    return (fa * 0.731).astype(np.float32), (fb * 0.731).astype(np.float32)


@pytest.mark.parametrize("mode", ["CWS", "DEF"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float64"])
def test_engine_dtype_matches_jax_engine(mode, dtype):
    kw = dict(frame_shape=SHAPE, wind_size=32, overlap=16, multipass=2,
              multipass_mode=mode, dtype=dtype, correlator="matmul")
    fa, fb = _frames(mode)
    jeng = JaxMultipassPIV(JaxPIVConfig(use_pallas="on", pallas_interpret=True, **kw))
    ju, jv, ji = jax.jit(jeng)(jnp.asarray(fa), jnp.asarray(fb))
    eng = MultipassPIV(PIVConfig(**kw), device="cpu")
    u, v, inval = eng(torch.from_numpy(fa), torch.from_numpy(fb))
    assert u.dtype == v.dtype == torch.float32
    np.testing.assert_array_equal(inval.numpy(), np.asarray(ji))
    d = np.abs(np.concatenate([(u.numpy() - np.asarray(ju)).ravel(),
                               (v.numpy() - np.asarray(jv)).ravel()]))
    assert np.sqrt(np.mean(d ** 2)) < 0.01
    assert (d > 0.01).mean() < 0.02
    if dtype == "float64":  # computed as float32, as the JAX package does
        f32 = MultipassPIV(PIVConfig(**{**kw, "dtype": "float32"}), device="cpu")
        u32, v32, _ = f32(torch.from_numpy(fa), torch.from_numpy(fb))
        assert torch.equal(u, u32) and torch.equal(v, v32)
