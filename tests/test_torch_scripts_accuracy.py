"""``tools/accuracy_table_cuda.py`` on the CPU against
``tools/accuracy_table.py``.

Both modules are loaded by path and their ``SWEEP`` is cut to three
sub-pixel fractions on the loaded module objects (the files are not
edited); the JAX module's ``run_engine`` is replaced there by the same
function with one ``jax.jit`` a configuration.  The port runs ``use_pallas="off"`` on the CPU, the JAX tool its
default ``jax.jit(MultipassPIV)``, which on the CPU is the same XLA path.
Every bias and RMS of the two configurations CWS/bilinear/gauss3 and
DEF/bicubic/gauss2d (sweep, shear, vortex) agrees within 0.01 px, the RMS
bound of the parity budget ``tests/test_torch_xla_paths.py`` holds these
paths to.  The second-peak rescue section's counts (8 noise seeds, the
glare blob) are equal.  ``--write --out`` writes the document with the
table.  The other two sections are in
``tests/test_torch_scripts_accuracy_sections.py``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CUT_SWEEP = np.array([0.0, 0.3, 0.7])
TOL = 0.01  # px


def _jit_once(jax_tool):
    """The JAX tool's ``run_engine`` with one ``jax.jit`` a configuration
    (the tool's own builds and compiles a new engine every call): the same
    engine and the same fields, compiled once."""
    import jax
    import jax.numpy as jnp

    cache = {}

    def run_engine(cfg_kw, fa, fb):
        key = tuple(sorted(cfg_kw.items()))
        if key not in cache:
            eng = jax_tool.MultipassPIV(jax_tool.PIVConfig(
                frame_shape=jax_tool.SHAPE, wind_size=64, overlap=32, multipass=2,
                **cfg_kw))
            cache[key] = eng, jax.jit(eng)
        eng, fn = cache[key]
        u, v, inval = fn(jnp.asarray(fa), jnp.asarray(fb))
        x, y = eng.final_coordinates
        return np.asarray(u), np.asarray(v), np.asarray(inval), x, y

    return run_engine


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    jax_tool = _load("tools/accuracy_table.py", "jax_accuracy_table")
    port = _load("tools/accuracy_table_cuda.py", "port_accuracy_table")
    jax_tool.SWEEP = CUT_SWEEP
    jax_tool.run_engine = _jit_once(jax_tool)
    port.SWEEP = CUT_SWEEP
    return jax_tool, port, port.Runner(torch.device("cpu"), "off")


@pytest.mark.parametrize("name", ["CWS/bilinear/gauss3", "DEF/bicubic/gauss2d"])
def test_table_rows_match_jax(tools, name):
    jax_tool, port, run = tools
    kw = dict(port.CONFIGS)[name]
    assert kw == dict(jax_tool.CONFIGS)[name]
    got = port.evaluate(run, kw)
    want = jax_tool.evaluate(kw)
    assert got.keys() == want.keys()
    for key in want:
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) < TOL, (key, got[key], want[key])


def test_rescue_section_matches_jax(tools):
    jax_tool, port, run = tools
    got = port.eval_rescue(run)
    want = jax_tool.eval_rescue()
    assert got == want


def test_write_goes_where_it_is_told(tools, tmp_path, capsys):
    _, port, _ = tools
    out = tmp_path / "ACCURACY_CUDA.md"
    assert port.main(["--device", "cpu", "--use-pallas", "off", "--configs",
                      "CWS/bilinear/gauss3", "--write", "--out", str(out)]) == 0
    text = out.read_text()
    printed = capsys.readouterr().out
    assert printed.splitlines()[0] == "cpu"
    assert "| CWS/bilinear/gauss3 |" in text and port.HEADER in text
    assert port.DOC.endswith("docs/ACCURACY_CUDA.md")
