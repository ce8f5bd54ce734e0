"""``tools/sustained_run_cuda.py`` on the CPU against the JAX engine of
``tools/sustained_run.py``.

* Every pair the tool finalizes, at 256x256 with 11 pairs in batches of 4
  (the last dispatch cut to 3), is ``(x, y, u, v)`` of the JAX
  ``MultipassPIV`` + ``pipeline.finalize_fields`` on the unique pair it
  was staged from (``(dispatch % staged + j) % n_unique``): ``x, y``
  equal, ``u, v`` within the port's parity budget (RMS < 0.01 px, fewer
  than 2% of the components more than 0.01 px apart; the fields are in
  px: scale 1, dt 1, times 1000).  The port runs ``use_pallas="off"``,
  the JAX engine its default, which on the CPU is the same XLA path.
* The count is exact: 11 pairs, not the 12 of three full dispatches.
* ``main`` prints the device line first and then the JAX tool's JSON keys.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu.pipeline import finalize_fields as jax_finalize_fields

REPO = Path(__file__).resolve().parents[1]
SIZE = (256, 256)
CPU = torch.device("cpu")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _load("tools/sustained_run_cuda.py", "port_sustained_run")


def _within_budget(got, want):
    (gx, gy, gu, gv), (wx, wy, wu, wv) = got, want
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    d = np.abs(np.concatenate([(gu - wu).ravel(), (gv - wv).ravel()])) / 1000.0
    assert np.sqrt(np.mean(d ** 2)) < 0.01
    assert (d > 0.01).mean() < 0.02


def test_every_finalized_pair_matches_jax(tool):
    pairs = tool.unique_pairs(SIZE, 3)
    seen = []
    out = tool.run(CPU, frame=SIZE, n_pairs=11, batch=4, staged=2, inflight=2,
                   engine_options={"use_pallas": "off"}, pairs=pairs,
                   on_field=lambda k, i, field: seen.append((k, i, field)))
    assert out["n_pairs"] == 11 and len(seen) == 11
    assert [k for k, _, _ in seen] == list(range(11))
    # dispatch d holds staged batch d % 2, whose entry j is pair (b + j) % 3
    assert [i for _, i, _ in seen] == [(d % 2 + j) % 3 for d in range(3)
                                       for j in range(4)][:11]
    eng = JaxMultipassPIV(JaxPIVConfig(frame_shape=SIZE, wind_size=64, overlap=32,
                                       multipass=2, multipass_mode="CWS"))
    fn = jax.jit(eng)
    x, y = eng.final_coordinates
    want = []
    for fa, fb in pairs:
        u, v, inval = (np.asarray(t) for t in fn(jnp.asarray(fa), jnp.asarray(fb)))
        want.append(jax_finalize_fields(u, v, inval, x, y, 1.0, 1.0))
    for _, i, field in seen:
        assert field is not None
        _within_budget(field, want[i])


def test_main_prints_the_device_and_the_json_keys(tool, monkeypatch, capsys):
    for key, value in (("PAIRS", "6"), ("BATCH", "4"), ("STAGED", "2"),
                       ("INFLIGHT", "2"), ("UNIQUE", "2")):
        monkeypatch.setenv(f"SUSTAINED_{key}", value)
    monkeypatch.setattr(tool, "FRAME", (128, 128))
    assert tool.main(["--device", "cpu", "--use-pallas", "off"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    line = json.loads(lines[-1])
    for key in ("metric", "value", "unit", "pairs_per_sec", "n_pairs"):
        assert key in line
    assert line["n_pairs"] == 6 and line["unit"] == "s" and line["value"] > 0
    assert line["pairs_per_sec"] > 0


def test_import_does_no_work_and_main_needs_a_card(tool, monkeypatch, capsys):
    monkeypatch.delenv("TPIV_DEVICE", raising=False)
    _load("tools/sustained_run_cuda.py", "port_sustained_run_again")
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
