"""The port's ``utils/profiling.py``, ``utils/database.py`` and
``utils/compile_cache.py`` on the CPU, the copies against the JAX
package's on the same inputs.

``StageTimers``, ``Throughput`` and ``Database`` are copies: the same
reports, rates and tables.  ``device_trace`` wraps ``torch.profiler``
(a Chrome trace in the log directory) where the JAX one wraps
``jax.profiler``.  ``enable_compile_cache`` resolves the one build
directory of the CUDA kernels and the native decoder, fixed by the first
call of a process, so its cases run in fresh interpreters."""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torchpiv_tpu.utils.database import Database as JaxDatabase
from torchpiv_tpu.utils.persistence import save_table as jax_save_table
from torchpiv_tpu.utils.profiling import StageTimers as JaxStageTimers
from torchpiv_tpu_torch.utils import compile_cache
from torchpiv_tpu_torch.utils.database import Database
from torchpiv_tpu_torch.utils.profiling import StageTimers, Throughput, device_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_stage_timers_report_like_the_jax_ones():
    reports = []
    for cls in (StageTimers, JaxStageTimers):
        timers = cls()
        for name in ("decode", "decode", "compute"):
            with timers.stage(name):
                time.sleep(0.005)
        reports.append(timers.report())
    got, want = reports
    assert list(got) == list(want) == ["compute", "decode"]
    for name in got:
        assert got[name]["count"] == want[name]["count"]
        assert set(got[name]) == set(want[name]) == {"total_s", "count", "mean_ms"}
        assert got[name]["mean_ms"] >= 4


def test_throughput_meter():
    t = Throughput()
    assert t.pairs_per_sec == 0.0
    t.tick(4)
    time.sleep(0.01)
    t.tick(4)
    assert t.count == 8 and 0 < t.pairs_per_sec < 8 / 0.01


def test_device_trace_noop_and_real(tmp_path):
    with device_trace(None):
        pass
    assert not list(tmp_path.iterdir())
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    trace = json.loads((logdir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::matmul" in names


def test_database_shared_state_and_load(tmp_path):
    """Every instance is one store; ``load`` reads a saved table as the
    JAX ``Database`` does."""
    y, x = np.mgrid[0:4, 0:5].astype(float)
    table = {"x[mm]": x, "y[mm]": y, "Vx[m/s]": np.sin(x + y), "Vy[m/s]": y * 0 - 1.0}
    jax_save_table("field.txt", str(tmp_path), table)
    a, b = Database(), Database()
    a.set({"k": np.ones(2)})
    assert b.get() is a.get()
    b.load(str(tmp_path / "field.txt"))
    jdb = JaxDatabase()
    jdb.load(str(tmp_path / "field.txt"))
    assert a.name == jdb.name == "field"
    assert list(a.get()) == list(jdb.get())
    for k in table:
        np.testing.assert_array_equal(a.get()[k], jdb.get()[k])
    a.set({})
    assert Database().get() == {}


def _fresh(code: str, **env) -> dict:
    """Run ``code`` in a fresh interpreter; it prints one JSON line."""
    run_env = dict(os.environ, PYTHONPATH=str(ROOT))
    run_env.pop("TORCHPIV_CACHE_DIR", None)
    run_env.update(env)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=run_env,
                         capture_output=True, text=True, timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


WHERE = r"""
import json, os
from torchpiv_tpu_torch.utils.compile_cache import enable_compile_cache
from torchpiv_tpu_torch.kernels import _build
from torchpiv_tpu_torch.native import loader
first = enable_compile_cache()
later = enable_compile_cache("/elsewhere")
ok = loader.available()
print(json.dumps({"first": first, "later": later, "kernels": str(_build.BUILD_DIR),
                  "target": str(_build._target("shift_windows").parent),
                  "fastio": str(loader.library_path().parent) if ok else None}))
"""


def test_compile_cache_default_directory():
    got = _fresh(WHERE)
    default = str(ROOT / "torchpiv_tpu_torch" / "_build")
    assert compile_cache.default_cache_dir() == default
    assert got["first"] == got["later"] == got["kernels"] == got["target"] == default
    assert got["fastio"] in (default, None)


def test_compile_cache_env_moves_kernels_and_fastio(tmp_path):
    """``TORCHPIV_CACHE_DIR`` moves the kernels' and the native decoder's
    libraries together; the first caller wins."""
    d = tmp_path / "cache"
    got = _fresh(WHERE, TORCHPIV_CACHE_DIR=str(d))
    assert got["first"] == got["later"] == got["kernels"] == got["target"] == str(d)
    if got["fastio"] is not None:  # built with g++ where there is one
        assert got["fastio"] == str(d)
        assert [p.name for p in d.iterdir()][0].startswith("libfastio-")


@pytest.mark.parametrize("arg", ["explicit", "env"])
def test_compile_cache_first_caller_wins(tmp_path, monkeypatch, arg):
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setenv("TORCHPIV_CACHE_DIR", str(tmp_path / "env"))
    want = str(tmp_path / ("explicit" if arg == "explicit" else "env"))
    first = compile_cache.enable_compile_cache(want if arg == "explicit" else None)
    assert first == want == str(compile_cache.build_dir())
    assert compile_cache.enable_compile_cache(str(tmp_path / "other")) == want
    assert not (tmp_path / "other").exists()
