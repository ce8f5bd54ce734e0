"""The window store type of the refine passes (``_window_store_dtype``)
in the port's engine on the CPU against the JAX engine (its Pallas kernels
interpreted) under ``correlator="matmul"``: CWS, DWS, CWS + bicubic,
``fused="split"`` and ``dtype="bfloat16"``, each at ``dft_precision=
"default"`` (bfloat16 window stores) beside ``"high"`` (float32) with one
tolerance.  DEF is in ``test_torch_store_dtype_def.py``.

The JAX engine stores the shift kernels' windows in bfloat16 under
``"default"``; on the CPU its matmul precision has no other effect, so the
two engines agree only where the port rounds the same windows at the store.
Without that rounding the port stays at ``"high"``'s windows and reads RMS
5.7e-4 px (CWS), 5.8e-4 (bicubic) and 5.5e-4 (``dtype="bfloat16"``) against
the JAX engine at ``"default"``, above these tolerances.  The bilinear
windows of ``fused="split"`` stay float32 in both engines.

Tolerances, on 256x256 ``particle_pair(..., (3.3, -2.1), seed=3)``, w32/o16,
2 passes: invalid masks equal; RMS of ``du, dv`` below 1e-5 px and their
largest difference below 2e-4 px (CWS, DWS, ``split``, ``dtype``); below
2e-5 and 5e-4 px for bicubic (its float32 results differ from the
interpreted kernel's by up to 1e-3 grey levels, ``test_torch_shift.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu_torch import MultipassPIV, PIVConfig
from torchpiv_tpu_torch.utils.synthetic import particle_pair

SHAPE = (256, 256)
CASES = {  # configuration -> (RMS, max) in px
    "CWS": (dict(multipass_mode="CWS"), (1e-5, 2e-4)),
    "DWS": (dict(multipass_mode="DWS"), (1e-5, 2e-4)),
    "CWS-bicubic": (dict(multipass_mode="CWS", cws_interp="bicubic"), (2e-5, 5e-4)),
    "CWS-split": (dict(multipass_mode="CWS", fused="split"), (1e-5, 2e-4)),
    "CWS-bfloat16": (dict(multipass_mode="CWS", dtype="bfloat16"), (1e-5, 2e-4)),
}


def engines_agree(extra, precision, tol):
    """Both engines on the same pair under ``correlator="matmul"`` and
    ``dft_precision=precision``; asserts the tolerance ``(rms, max)``."""
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=3)
    kw = dict(frame_shape=SHAPE, wind_size=32, overlap=16, multipass=2,
              correlator="matmul", dft_precision=precision, **extra)
    jeng = JaxMultipassPIV(JaxPIVConfig(use_pallas="on", pallas_interpret=True, **kw))
    ju, jv, ji = (np.asarray(t) for t in jax.jit(jeng)(jnp.asarray(fa), jnp.asarray(fb)))
    eng = MultipassPIV(PIVConfig(**kw), device="cpu")
    want_store = torch.bfloat16 if precision == "default" else torch.float32
    assert eng._window_store_dtype() == want_store
    u, v, inval = eng(torch.from_numpy(fa)[None], torch.from_numpy(fb)[None])
    np.testing.assert_array_equal(inval[0].numpy(), ji)
    d = np.abs(np.concatenate([(u[0].numpy() - ju).ravel(), (v[0].numpy() - jv).ravel()]))
    rms, worst = tol
    assert np.sqrt(np.mean(d ** 2)) < rms, np.sqrt(np.mean(d ** 2))
    assert d.max() < worst, d.max()


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_store_type_matches_jax_engine(case, precision):
    extra, tol = CASES[case]
    engines_agree(extra, precision, tol)


@pytest.mark.parametrize("kw", [
    dict(correlator="matmul", dft_precision="default"),
    dict(correlator="matmul", dft_precision="high"),
    dict(correlator="matmul", dft_precision="highest"),
    dict(correlator="auto", dft_precision="default"),
    dict(correlator="fft", dft_precision="default"),
    dict(correlator="matmul", dft_precision="default", window_weight="gaussian"),
])
def test_window_store_type_is_the_jax_engines(kw):
    """The rule, configuration by configuration, against the JAX engine's
    own ``_window_store_dtype`` off the TPU."""
    cfg = dict(frame_shape=(128, 128), wind_size=32, overlap=16, multipass=2, **kw)
    want = JaxMultipassPIV(JaxPIVConfig(**cfg))._window_store_dtype()
    got = MultipassPIV(PIVConfig(**cfg), device="cpu")._window_store_dtype()
    assert str(got).removeprefix("torch.") == jnp.dtype(want).name


@pytest.mark.parametrize("extra,unsharded_store", [
    (dict(multipass_mode="CWS"), torch.bfloat16),
    (dict(multipass_mode="DEF"), torch.bfloat16),
    (dict(multipass_mode="CWS", fused="split"), torch.float32),
], ids=["CWS", "DEF", "CWS-split"])
def test_window_split_inherits_the_store_type(extra, unsharded_store, monkeypatch):
    """``ShardedPIV``'s window split runs the engine's own refine pass on
    row blocks, so its kernels store what the JAX window split's do:
    bfloat16 under ``"default"``, the split mode's bilinear windows too (the
    JAX window split takes them from ``_shift``, not from the packed
    kernel), while the unsharded split mode stores them float32.  The split
    stays within the parity budget of the unsharded engine."""
    from torchpiv_tpu_torch.models import multipass
    from torchpiv_tpu_torch.parallel import ShardedPIV, make_mesh

    stores = []
    for name in ("shift_windows", "def_windows"):
        real = getattr(multipass, name)

        def spy(*a, _real=real, out_dtype=torch.float32, **k):
            stores.append(out_dtype)
            return _real(*a, out_dtype=out_dtype, **k)
        monkeypatch.setattr(multipass, name, spy)
    fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=3)
    fa, fb = torch.from_numpy(fa)[None], torch.from_numpy(fb)[None]
    cfg = PIVConfig(frame_shape=SHAPE, wind_size=32, overlap=16, multipass=2,
                    correlator="matmul", dft_precision="default", **extra)
    eng = MultipassPIV(cfg, device="cpu")
    u0, v0, i0 = (t.numpy() for t in eng(fa, fb))
    assert set(stores) == {unsharded_store}
    stores.clear()
    cpu = torch.device("cpu")
    u, v, inval = (t.numpy() for t in ShardedPIV(
        eng, make_mesh({"pairs": 1, "windows": 2}, [cpu] * 2))(fa, fb))
    assert set(stores) == {torch.bfloat16}
    assert np.mean(inval != i0) < 0.02
    both = ~(inval | i0)
    assert np.sqrt(np.mean((u - u0)[both] ** 2)) < 0.01
    assert np.sqrt(np.mean((v - v0)[both] ** 2)) < 0.01
