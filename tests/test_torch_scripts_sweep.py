"""``tools/bench_sweep_cuda.py`` on the CPU against ``tools/bench_sweep.py``.

* ``CONFIGS`` is the JAX tool's list, label for label, and every
  configuration's vector grid at 256x256 is the JAX engine's
  ``final_field_shape``; two configurations are timed through the port's
  production dispatch (``pipeline.packed_forward``) at batch 2, their grid
  the output's shape.
* A configuration that fails prints ``FAILED`` and the sweep goes on.
* ``main`` prints the device line first and then the JAX tool's two table
  headers; importing the tool does nothing, and without a card ``main``
  raises naming ``device='cpu'``.

The JAX tool enables a persistent compilation cache when it is imported,
so its ``CONFIGS`` are read from its source without running it."""
import ast
import importlib.util
from pathlib import Path

import pytest
import torch

from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig

REPO = Path(__file__).resolve().parents[1]
SIZE = (256, 256)
CPU = torch.device("cpu")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_tool_names(path, *names):
    """The top-level definitions ``names`` of a JAX tool, run from its
    source alone (no import of the tool, so none of its side effects)."""
    tree = ast.parse((REPO / path).read_text())
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name in names)
            or (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) in names for t in node.targets))]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return [ns[n] for n in names]


@pytest.fixture(scope="module")
def tool():
    return _load("tools/bench_sweep_cuda.py", "port_bench_sweep")


def test_configs_are_the_jax_tools_and_grids_the_jax_engines(tool):
    (jax_configs,) = jax_tool_names("tools/bench_sweep.py", "CONFIGS")
    assert tool.CONFIGS == jax_configs
    assert tool.FRAME == (2048, 2048) and tool.BATCHES == (4, 8, 16, 32)
    for label, overrides in tool.CONFIGS:
        want = JaxMultipassPIV(JaxPIVConfig(frame_shape=SIZE, **overrides)).final_field_shape
        assert tuple(tool.build(overrides, CPU, SIZE).final_field_shape) == tuple(want), label
    pairs = tool.unique_pairs(SIZE)
    rows = tool.sweep_configs(CPU, tool.CONFIGS[:2], batch=2, reps=1, frame=SIZE,
                              pairs=pairs)
    for (label, overrides), row in zip(tool.CONFIGS[:2], rows):
        want = JaxMultipassPIV(JaxPIVConfig(frame_shape=SIZE, **overrides)).final_field_shape
        assert row["label"] == label and "error" not in row
        assert row["grid"] == row["final_field_shape"] == tuple(want)
        assert row["ms_pair"] > 0 and row["pairs_s"] > 0 and row["compile_first_s"] > 0


def test_a_failing_configuration_prints_failed_and_the_sweep_goes_on(tool, capsys):
    configs = [("bad", dict(wind_size=300, overlap=16)), tool.CONFIGS[1]]
    rows = tool.sweep_configs(CPU, configs, batch=2, reps=1, frame=SIZE)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("bad") and "FAILED" in out[0]
    assert "error" in rows[0] and "error" not in rows[1]
    assert out[1].startswith("w64 o32 2xCWS") and "ms/pair" in out[1]


def test_main_prints_the_device_and_the_jax_tables(tool, monkeypatch, capsys):
    monkeypatch.setattr(tool, "FRAME", (128, 128))
    monkeypatch.setattr(tool, "BATCH", 2)
    monkeypatch.setattr(tool, "REPS", 1)
    monkeypatch.setattr(tool, "BATCHES", (2, 4))
    monkeypatch.setattr(tool, "CONFIGS", tool.CONFIGS[:2])
    assert tool.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    assert "| config | ms/pair | pairs/s | vector grid |" in lines
    assert "| scan batch | ms/pair | pairs/s |" in lines
    i = lines.index("| scan batch | ms/pair | pairs/s |")
    assert [ln.split(" | ")[0] for ln in lines[i + 2:i + 4]] == ["| 2", "| 4"]


def test_import_does_no_work_and_main_needs_a_card(tool, monkeypatch, capsys):
    monkeypatch.delenv("TPIV_DEVICE", raising=False)
    _load("tools/bench_sweep_cuda.py", "port_bench_sweep_again")
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])
