"""The smoothing and SCC/RPC contamination sections of
``tools/accuracy_table_cuda.py`` on the CPU against
``tools/accuracy_table.py``'s (the table is in
``tests/test_torch_scripts_accuracy.py``).

The port runs ``use_pallas="off"`` on the CPU, the JAX tool its default
``jax.jit(MultipassPIV)``, which on the CPU is the same XLA path; the JAX
module's ``run_engine`` is replaced on the loaded module object by the
same function with one ``jax.jit`` a configuration.  The
contamination section's RMS and bias (four amplitudes, three seeds, SCC
and RPC) and the smoothing section's raw and smoothed RMS (shear and
vortex at three seedings) agree within 0.01 px, the RMS bound of the
parity budget ``tests/test_torch_xla_paths.py`` holds these paths to.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
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
    jax_tool = _load("tools/accuracy_table.py", "jax_accuracy_sections")
    jax_tool.run_engine = _jit_once(jax_tool)
    return jax_tool, _load("tools/accuracy_table_cuda.py", "port_accuracy_sections")


def test_rpc_section_matches_jax(tools):
    jax_tool, port = tools
    run = port.Runner(torch.device("cpu"), "off")
    got = port.eval_rpc(run)
    want = jax_tool.eval_rpc()
    assert got.keys() == want.keys()
    for amp in want:
        for corr in ("scc", "rpc"):
            for g, w in zip(got[amp][corr], want[amp][corr]):
                assert np.isfinite(g) and abs(g - w) < TOL, (amp, corr, g, w)


def test_smoothing_section_matches_jax(tools):
    jax_tool, port = tools
    run = port.Runner(torch.device("cpu"), "off")
    kw = port.CONFIGS[0][1]
    got = port.eval_smoothing(run, kw)
    want = jax_tool.eval_smoothing(kw)
    assert got.keys() == want.keys()
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert abs(g - w) < TOL, (key, g, w)
