"""``examples/{demo,postprocess_demo,sharded_demo}_cuda.py`` on the CPU
against the JAX examples they port (``dense_demo`` and
``tracking_pressure_demo`` are in
``tests/test_torch_scripts_examples_models.py``), and every script beside
the package without a card.

Each example is loaded by path and run through ``main`` into its own
output directory: the JAX one as it stands (on the CPU its engine is the
XLA path), the port's with ``--device cpu --use-pallas off`` (the same
path as torch ops).  Their printed numbers are compared within one unit
of the last printed digit plus:

* ``demo``: the same pair count; peak |V| within 0.25 m/s (the parity
  budget's 0.01 px at scale 0.05 mm/px and dt 2 us: 25 m/s a px); the
  13-column statistics files with ``x, y`` equal, the two mean-velocity
  columns within 0.25 m/s and every other column within 1% of its
  largest magnitude; the same figure files.
* ``postprocess_demo``: the median uncertainty within 1e-4 relative (the
  quality maps' tolerance in ``tests/test_torch_quality.py``) and the
  POD mode-0 energy within one printed percent.
* ``sharded_demo``: a mesh of 8 entries (``{"pairs": 4, "windows": 2}``)
  against the JAX demo on the conftest's 8 virtual CPU devices: the mesh
  line's axes, each pair's mean u within 0.01 px and its valid share
  equal; the port's fields against the JAX demo's computation
  (``ShardedPIV(engine, default_piv_mesh()).jit()``) within the parity
  budget (mask mismatch < 2%, RMS < 0.01 px on jointly valid vectors).

Without a card, ``main`` of every ``examples/*_cuda.py`` and
``tools/{sustained_run,coldstart,accuracy_table,degraded_campaign}_cuda.py``
raises naming ``device='cpu'`` and loading it prints nothing;
``TPIV_DEVICE=cpu`` runs one on the CPU.
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = ["examples/demo_cuda.py", "examples/postprocess_demo_cuda.py",
           "examples/dense_demo_cuda.py", "examples/tracking_pressure_demo_cuda.py",
           "examples/sharded_demo_cuda.py", "tools/sustained_run_cuda.py",
           "tools/coldstart_cuda.py", "tools/accuracy_table_cuda.py",
           "tools/degraded_campaign_cuda.py"]
NUMBER = r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numbers(text: str, pattern: str) -> list:
    """The numbers of the first line of ``text`` that matches ``pattern``
    (a regex with ``{n}`` where a number stands)."""
    rx = re.compile(pattern.replace("{n}", f"({NUMBER})"))
    for line in text.splitlines():
        m = rx.search(line)
        if m:
            return [float(g) for g in m.groups()]
    raise AssertionError(f"no line matches {pattern!r} in:\n{text}")


def _run_both(name, tmp_path, capsys, jax_args=None):
    """Run the JAX example and the port's; returns their standard output."""
    jax_main = _load(f"examples/{name}.py", f"jax_{name}").main
    if jax_args is None:
        jax_main(str(tmp_path / "jax"))
    else:
        jax_main(*jax_args)
    want = capsys.readouterr().out
    port = _load(f"examples/{name}_cuda.py", f"port_{name}")
    assert port.main([str(tmp_path / "port"), "--device", "cpu", "--use-pallas", "off"]
                     if name != "sharded_demo" else
                     ["--devices", "8", "--device", "cpu", "--use-pallas", "off"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == "cpu"
    return got, want


def test_demo_matches_jax(tmp_path, capsys):
    got, want = _run_both("demo", tmp_path, capsys)
    pattern = r"processed {n} pairs; peak \|V\| = {n} m/s"
    (gn, gv), (wn, wv) = _numbers(got, pattern), _numbers(want, pattern)
    assert gn == wn == 4
    assert abs(gv - wv) <= 0.25 + 0.01
    g = np.loadtxt(tmp_path / "port" / "frames_statistics.txt", delimiter=",", skiprows=1)
    w = np.loadtxt(tmp_path / "jax" / "frames_statistics.txt", delimiter=",", skiprows=1)
    assert g.shape == w.shape and g.shape[1] == 13
    np.testing.assert_array_equal(g[:, :2], w[:, :2])
    assert np.abs(g[:, 2:4] - w[:, 2:4]).max() <= 0.25
    for c in range(4, 13):
        assert np.abs(g[:, c] - w[:, c]).max() <= 0.01 * np.abs(w[:, c]).max(), c
    assert (tmp_path / "port" / "demo_field.png").stat().st_size > 0


def test_postprocess_demo_matches_jax(tmp_path, capsys):
    got, want = _run_both("postprocess_demo", tmp_path, capsys)
    pattern = r"median uncertainty {n} px; POD mode-0 energy {n}%"
    (gu, ge), (wu, we) = _numbers(got, pattern), _numbers(want, pattern)
    assert abs(gu - wu) <= 1e-4 * abs(wu) + 0.001
    assert abs(ge - we) <= 1
    assert (tmp_path / "port" / "postprocess_demo.png").stat().st_size > 0


def test_sharded_demo_matches_jax(tmp_path, capsys):
    from torchpiv_tpu.models import MultipassPIV, PIVConfig
    from torchpiv_tpu.parallel import ShardedPIV, default_piv_mesh
    from torchpiv_tpu.utils.synthetic import particle_pair

    assert len(jax.devices()) == 8
    got, want = _run_both("sharded_demo", tmp_path, capsys, jax_args=())
    assert "{'pairs': 4, 'windows': 2}" in got and "{'pairs': 4, 'windows': 2}" in want
    for i in range(4):
        pattern = rf"pair {i}: mean u = {{n}} px \(true {{n}}\), valid {{n}}%"
        (gu, gt, gv), (wu, wt, wv) = _numbers(got, pattern), _numbers(want, pattern)
        assert gt == wt and gv == wv
        assert abs(gu - wu) <= 0.01 + 0.001
    # the JAX demo's computation, whose fields it does not return
    pairs = [particle_pair((512, 512), displacement=(3.0 + 0.2 * i, -1.5), seed=i)
             for i in range(4)]
    fa, fb = (jnp.asarray(np.stack([p[k] for p in pairs])) for k in (0, 1))
    engine = MultipassPIV(PIVConfig(frame_shape=(512, 512), wind_size=64, overlap=32,
                                    multipass=2, multipass_mode="CWS"))
    wu, wv, wi = (np.asarray(t) for t in ShardedPIV(engine, default_piv_mesh()).jit()(fa, fb))
    port = _load("examples/sharded_demo_cuda.py", "port_sharded_fields")
    out = port.run(torch.device("cpu"), 8, "off")
    both = ~(out["invalid"] | wi)
    assert np.mean(out["invalid"] != wi) < 0.02
    d = np.concatenate([(out["u"] - wu)[both], (out["v"] - wv)[both]])
    assert np.sqrt(np.mean(d ** 2)) < 0.01


@pytest.mark.parametrize("path", SCRIPTS)
def test_script_needs_a_card_unless_asked_for_the_cpu(path, tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("TPIV_DEVICE", raising=False)
    mod = _load(path, "no_card_" + Path(path).stem)
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path)] if path.startswith("examples/") else []
    if path.endswith("sharded_demo_cuda.py"):
        argv = []
    if path.endswith("coldstart_cuda.py"):  # a small folder, made first
        mod.make_dataset(str(tmp_path / "pairs"), 2, (64, 64))
        argv = ["--folder", str(tmp_path / "pairs")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
    assert capsys.readouterr().out == ""


def test_tpiv_device_cpu_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("TPIV_DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = _load("examples/sharded_demo_cuda.py", "port_sharded_env")
    assert port.main(["--devices", "2", "--use-pallas", "off"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu" and "{'pairs': 2}" in out[1]
