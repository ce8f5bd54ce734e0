"""``tools/bench_engine_ab_cuda.py`` on the CPU against
``tools/bench_engine_ab.py``.

* ``parse_setting`` is the JAX tool's on a list of settings.
* The two settings ``off`` and ``split`` at 256x256, batch 2, CWS: each
  setting's fields within the port's parity budget (RMS < 0.01 px, fewer
  than 2% of the components more than 0.01 px apart, invalid flags on at
  least 98% of the windows the same) of the JAX tool's engine for the same
  setting (its ``lax.scan`` over the pairs; its Pallas kernels interpreted,
  as the JAX package's tests run them on the CPU), and the agreement line
  within that budget too.
* ``main`` prints the device line first, then one line a setting and the
  agreement line; without a card it raises naming ``device='cpu'``.

The JAX tool configures a persistent compilation cache when it is
imported, so its ``parse_setting`` is read from its source without
running it."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig

REPO = Path(__file__).resolve().parents[1]
SIZE = (256, 256)
CPU = torch.device("cpu")
SETTINGS = ["off", "split", "on", "auto", "extract_variant=stack",
            "fused=split, correlator = matmul,dft_precision=default",
            "shift_variant=bf16", "k=a=b"]

_spec = importlib.util.spec_from_file_location(
    "sweep_tests", Path(__file__).with_name("test_torch_scripts_sweep.py"))
_sweep_tests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_sweep_tests)


@pytest.fixture(scope="module")
def tool():
    return _sweep_tests._load("tools/bench_engine_ab_cuda.py", "port_bench_engine_ab")


def test_parse_setting_is_the_jax_tools(tool):
    (jax_parse,) = _sweep_tests.jax_tool_names("tools/bench_engine_ab.py", "parse_setting")
    for s in SETTINGS:
        assert tool.parse_setting(s) == jax_parse(s), s
    assert tool.FRAME == (2048, 2048) and tool.MODE == "CWS" and tool.BATCH == 8


def _jax_fields(setting, parse, pairs, batch):
    """The JAX tool's engine for ``setting`` (its ``build``), at ``SIZE``,
    with its Pallas kernels interpreted."""
    cfg = JaxPIVConfig(frame_shape=SIZE, wind_size=64, overlap=32, multipass=2,
                       multipass_mode="CWS", use_pallas="on", pallas_interpret=True,
                       **parse(setting))
    engine = JaxMultipassPIV(cfg)

    def batched(fa, fb):
        def step(carry, ab):
            u, v, inval = engine(ab[0], ab[1])
            if inval is None:
                inval = jnp.zeros(u.shape, bool)
            return carry, (u, v, inval)
        _, out = jax.lax.scan(step, 0, (fa, fb))
        return out

    fa = jnp.asarray(np.stack([pairs[i % len(pairs)][0] for i in range(batch)]))
    fb = jnp.asarray(np.stack([pairs[i % len(pairs)][1] for i in range(batch)]))
    return [np.asarray(o) for o in jax.jit(batched)(fa, fb)]


def _within_budget(got, want):
    assert np.mean(got[2] == want[2]) >= 0.98
    both = ~(got[2] | want[2])
    d = np.abs(np.concatenate([(got[0] - want[0])[both], (got[1] - want[1])[both]]))
    assert np.sqrt(np.mean(d ** 2)) < 0.01
    assert (d > 0.01).mean() < 0.02


def test_ab_fields_are_the_jax_tools(tool):
    pairs = tool.unique_pairs(SIZE)
    out = tool.ab(["off", "split"], CPU, frame=SIZE, batch=2, pairs=pairs)
    for run in out["runs"]:
        assert run["final_field_shape"] == run["fields"][0].shape[-2:]
        assert run["ms_pair"] > 0 and run["first_s"] > 0
        _within_budget(run["fields"], _jax_fields(run["setting"], tool.parse_setting,
                                                  pairs, 2))
    agreed = out["agreement"]
    assert agreed["mask_agree"] >= 0.98
    assert agreed["du_rms"] < 0.01 and agreed["dv_rms"] < 0.01


def test_main_prints_the_device_the_settings_and_their_agreement(tool, monkeypatch, capsys):
    monkeypatch.setattr(tool, "FRAME", (128, 128))
    monkeypatch.setattr(tool, "BATCH", 2)
    assert tool.main(["--device", "cpu", "off", "correlator=matmul,dft_precision=default"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    assert lines[1].startswith("off ") and "ms/pair" in lines[1] and "at batch 2" in lines[1]
    assert lines[2].startswith("correlator=matmul,dft_precision=default")
    assert lines[3].startswith("fields off vs correlator=matmul,dft_precision=default: "
                               "mask agree ")


def test_import_does_no_work_and_main_needs_a_card(tool, monkeypatch, capsys):
    monkeypatch.delenv("TPIV_DEVICE", raising=False)
    _sweep_tests._load("tools/bench_engine_ab_cuda.py", "port_bench_engine_ab_again")
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
