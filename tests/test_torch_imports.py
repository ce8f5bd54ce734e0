"""The port stands alone: no module of ``torchpiv_tpu_torch``, nothing
that ``chip_smoke.py`` imports and none of the scripts beside the package
(``examples/*_cuda.py``, ``tools/*_cuda.py`` of the user-facing scripts)
loads JAX or any module of the JAX package ``torchpiv_tpu``.  A fresh
interpreter imports every module of the port (``pkgutil.walk_packages``)
and every module named by an ``import`` statement of ``chip_smoke.py`` (at
any depth of the file), then reports what ``sys.modules`` holds; another
loads each script by path and imports what its statements name."""
import ast
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHILD = r"""
import importlib, json, pkgutil, sys
import torchpiv_tpu_torch

failed = {}
names = [m.name for m in pkgutil.walk_packages(torchpiv_tpu_torch.__path__,
                                               "torchpiv_tpu_torch.")]
names += json.loads(sys.argv[1])
for name in names:
    try:
        importlib.import_module(name)
    except ImportError as exc:  # an optional dependency this machine lacks
        failed[name] = repr(exc)
print(json.dumps({"imported": names, "failed": failed,
                  "modules": sorted(sys.modules)}))
"""


def _jax_or_reference(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "torchpiv_tpu")


def chip_smoke_imports():
    """Module names of every ``import`` statement in ``chip_smoke.py``."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return sorted(names)


def test_chip_smoke_names_no_jax_module():
    names = chip_smoke_imports()
    assert "torchpiv_tpu_torch.kernels" in names
    assert not [n for n in names if _jax_or_reference(n)]


def test_port_and_chip_smoke_load_no_jax_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(chip_smoke_imports())],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    port = [n for n in report["imported"] if n.startswith("torchpiv_tpu_torch.")]
    assert "torchpiv_tpu_torch.models.ptv" in port and "torchpiv_tpu_torch.calib.stereo" in port
    # every module of the port imports here (cv2 and scipy's extras aside)
    assert not [n for n in report["failed"] if n.startswith("torchpiv_tpu_torch")], \
        report["failed"]
    loaded = [n for n in report["modules"] if _jax_or_reference(n)]
    assert not loaded, loaded


# the scripts beside the package: each is loaded by path in the child, and
# every module its import statements name (at any depth) is imported
SCRIPTS = ["examples/demo_cuda.py", "examples/postprocess_demo_cuda.py",
           "examples/dense_demo_cuda.py", "examples/tracking_pressure_demo_cuda.py",
           "examples/sharded_demo_cuda.py", "tools/sustained_run_cuda.py",
           "tools/coldstart_cuda.py", "tools/accuracy_table_cuda.py",
           "tools/degraded_campaign_cuda.py", "tools/bench_sweep_cuda.py",
           "tools/bench_engine_ab_cuda.py", "tools/profile_engine_cuda.py"]

SCRIPT_CHILD = r"""
import importlib, importlib.util, json, sys

paths, names = json.loads(sys.argv[1]), json.loads(sys.argv[2])
for i, path in enumerate(paths):
    spec = importlib.util.spec_from_file_location(f"script_{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in names:
    importlib.import_module(name)
print(json.dumps(sorted(sys.modules)))
"""


def file_imports(path):
    """Module names of every ``import`` statement in ``path``."""
    names = set()
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return sorted(names)


def test_scripts_name_no_jax_module():
    for path in SCRIPTS:
        names = file_imports(path)
        assert any(n.startswith("torchpiv_tpu_torch") for n in names), path
        assert not [n for n in names if _jax_or_reference(n)], path


def test_scripts_load_no_jax_module():
    # matplotlib is optional: the figures are skipped without it
    names = sorted(n for n in {n for p in SCRIPTS for n in file_imports(p)}
                   if not n.startswith("matplotlib"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT_CHILD, json.dumps([str(ROOT / p) for p in SCRIPTS]),
         json.dumps(names)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300, check=True)
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torchpiv_tpu_torch.parallel.sharded" in modules
    loaded = [n for n in modules if _jax_or_reference(n)]
    assert not loaded, loaded
