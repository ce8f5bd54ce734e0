"""``examples/{dense_demo,tracking_pressure_demo}_cuda.py`` on the CPU
against the JAX examples they port.

Each example runs through ``main`` into its own output directory: the JAX
one as it stands (on the CPU its engine is the XLA path), the port's with
``--device cpu --use-pallas off`` (the same path as torch ops).  Their
printed numbers are compared within one unit of the last printed digit
plus:

* ``dense_demo``: each of the three u-error RMS values (correlation,
  dense LK, hybrid) within 1e-3 px, the dense fields' tolerance in
  ``tests/test_torch_models.py``;
* ``tracking_pressure_demo``: the detected and tracked particle counts
  and the Gamma1 core's grid node equal (``tests/test_torch_particles.py``
  holds the tracks to >= 99% common), |Gamma1| at the core and the
  pressure at the core and its minimum within 1% relative.

The figures are written by both.
"""
import importlib.util
import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
NUMBER = r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numbers(text: str, pattern: str) -> list:
    rx = re.compile(pattern.replace("{n}", f"({NUMBER})"))
    for line in text.splitlines():
        m = rx.search(line)
        if m:
            return [float(g) for g in m.groups()]
    raise AssertionError(f"no line matches {pattern!r} in:\n{text}")


def _run_both(name, tmp_path, capsys):
    _load(f"examples/{name}.py", f"jax_{name}").main(str(tmp_path / "jax"))
    want = capsys.readouterr().out
    port = _load(f"examples/{name}_cuda.py", f"port_{name}")
    assert port.main([str(tmp_path / "port"), "--device", "cpu", "--use-pallas", "off"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == "cpu"
    return got, want


def test_dense_demo_matches_jax(tmp_path, capsys):
    got, want = _run_both("dense_demo", tmp_path, capsys)
    for name in ("correlation (2-pass CWS)", "dense LK", "hybrid (corr-anchored LK)"):
        pattern = re.escape(name) + r": {n} px RMS"
        (g,), (w,) = _numbers(got, pattern), _numbers(want, pattern)
        assert abs(g - w) <= 1e-3 + 1e-4, name
    assert (tmp_path / "port" / "dense_demo.png").stat().st_size > 0


def test_tracking_pressure_demo_matches_jax(tmp_path, capsys):
    got, want = _run_both("tracking_pressure_demo", tmp_path, capsys)
    pattern = r"{n} particles detected, {n} tracked"
    assert _numbers(got, pattern) == _numbers(want, pattern)
    # the JAX demo prints the core's indices as numpy integers
    index = r"(?:np\.int64\()?{n}\)?"
    pattern = rf"Gamma1 core at grid \({index}, {index}\), \|Gamma1\| {{n}}"
    g_core, w_core = _numbers(got, pattern), _numbers(want, pattern)
    assert g_core[:2] == w_core[:2]
    assert abs(g_core[2] - w_core[2]) <= 0.01 * abs(w_core[2]) + 0.01
    pattern = r"pressure at core {n} \(field min {n}\)"
    for g, w in zip(_numbers(got, pattern), _numbers(want, pattern)):
        assert abs(g - w) <= 0.01 * abs(w) + 0.01
    assert (tmp_path / "port" / "tracking_pressure_demo.png").stat().st_size > 0
