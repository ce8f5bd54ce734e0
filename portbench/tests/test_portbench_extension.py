"""A configuration that brings its own reference and a mix that brings its
own drive run through ``cell.run`` as new files and ``BENCHMARK.json``
entries alone; unknown names stop the run before any set-up."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib import cell as cellmod  # noqa: E402

TOY_REFERENCE = '''"""A toy reference: each pair's answer is frame B's mean grey level
less frame A's, in u, on a 2 x 2 grid."""
import numpy as np
import torch


def settings(cfg):
    if set(cfg) - {"frame_shape", "gain"}:
        raise ValueError(f"the toy reference does not compute {sorted(cfg)}")
    return {"scale": 1.0, "dt": 1.0, **cfg}


def run(frame_a, frame_b, cfg, precision="float64"):
    dtype = torch.float64 if precision == "float64" else torch.float32
    d = float(cfg["gain"] * (frame_b.to(dtype).mean() - frame_a.to(dtype).mean()))
    x, y = np.meshgrid([8.0, 24.0], [8.0, 24.0])
    u = np.full((2, 2), d * 1000.0)
    return (x, y, u, np.zeros((2, 2))), np.zeros((2, 2), dtype=bool)
'''

TOY_DRIVE = '''"""A toy drive: the window answers the staged pairs in turn, in float32
on their device, each answer off by the mix's ``offset`` (px)."""
import random
import time

import numpy as np

from .sample import Reservoir

DRIVE = True


def setup(cell, device, seconds, seed):
    return {"gain": float(cell.config["engine"]["gain"])}


def window(cell, state, seconds, seed, traced, on_open=None, on_close=None):
    fa, fb = cell.frames
    x, y = np.meshgrid([8.0, 24.0], [8.0, 24.0])
    sample = Reservoir(cell.check_pairs, random.Random(seed))
    t0 = time.perf_counter()
    fields = 0
    while time.perf_counter() < t0 + seconds:
        k = fields % fa.shape[0]
        d = state["gain"] * float(fb[k].float().mean() - fa[k].float().mean())
        u = np.full((2, 2), (d + cell.traffic["offset"]) * 1000.0)
        sample.offer(lambda: {"pair": k, "field": (x, y, u, np.zeros((2, 2))),
                              "invalid": np.zeros((2, 2), dtype=bool)})
        fields += 1
    return {"t0": t0, "fields": fields, "seconds": seconds, "attempted": fields,
            "failed": 0, "samples": sample.items}


def teardown(state):
    state.clear()
'''

PARTICLES = {"density": 0.02, "diameter": 2.5, "noise": 2.0, "background": 8.0}
FLOW = {"uniform": [1.0, 0.5]}
LIMITS = {"check_pairs": 2, "least_checked": 2,
          "limits": {"xy_gap_px": 0.0, "skip_mismatch": 0.0, "uv_gap_p99_px": 1e-3}}

# the toy files, each new to the copy: path under portbench/ -> content
FILES = {
    "configs/toy.json": {"name": "toy", "source": "a test's toy", "frame_shape": [32, 32],
                         "engine": {"gain": 1.0}, "batch": 2, "reference": "toy",
                         "reduced": []},
    "configs/toy_noref.json": {"name": "toy_noref", "frame_shape": [32, 32],
                               "engine": {"gain": 1.0}, "batch": 2, "reference": "nosuch"},
    "reference/toy.py": TOY_REFERENCE,
    "lib/toydrive.py": TOY_DRIVE,
    "traffic/toy.json": {"drive": "toydrive", "unique_pairs": 4, "offset": 0.0,
                         "particles": PARTICLES, "flow": FLOW},
    "traffic/toy_off.json": {"drive": "toydrive", "unique_pairs": 4, "offset": 0.01,
                             "particles": PARTICLES, "flow": FLOW},
    "traffic/toy_nodrive.json": {"drive": "nosuch", "unique_pairs": 4},
    "traffic/toy_check.json": {"drive": "check", "unique_pairs": 4},
    "metrics/toy_fields_per_s.py": '"""Answers a second."""\n\n\ndef read(rec):\n'
                                   '    return rec.fields / rec.seconds\n',
}
CELLS = {"toy.ok": ("toy", "toy"), "toy.off": ("toy", "toy_off"),
         "toy.noref": ("toy_noref", "toy"), "toy.nodrive": ("toy", "toy_nodrive"),
         "toy.check": ("toy", "toy_check")}

SCRIPT = '''
import json, sys, time
sys.path.insert(0, ".")
import torch
from portbench.lib import cell
out = {}
for name in ("toy.ok", "toy.off"):
    line = cell.run(name, 2**31 + 3, 0.3, False, torch.device("cpu"), time.perf_counter())
    out[name] = {"correct": line["correct"], "check": line["check"],
                 "metrics": sorted(line["metrics"])}
for name in ("toy.noref", "toy.nodrive", "toy.check"):
    try:
        cell.run(name, 2**31 + 3, 0.3, False, torch.device("cpu"), time.perf_counter())
        out[name] = "ran"
    except SystemExit as e:
        out[name] = str(e)
print(json.dumps(out))
'''


def _digests(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    """A copy of ``portbench/`` and ``BENCHMARK.json`` with the toy files
    and entries added, the toy cells run in it, and the copy's files before
    and after."""
    copy = tmp_path_factory.mktemp("bench")
    shutil.copytree(os.path.join(ROOT, "portbench"), copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    before = _digests(copy / "portbench")
    for rel, content in FILES.items():
        path = copy / "portbench" / rel
        assert not path.exists(), rel
        path.write_text(content if isinstance(content, str) else json.dumps(content))
    for name in CELLS:
        (copy / "portbench" / "limits" / f"{name}.json").write_text(json.dumps(LIMITS))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "toy", "source": "a test's toy",
                             "file": "portbench/configs/toy.json", "reduced": [],
                             "why": "a toy"})
    for name, (config, traffic) in CELLS.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a toy"})
    bench["end_to_end"].append({"name": "toy_fields_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": list(CELLS)})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(copy)
    done = subprocess.run([sys.executable, "-c", SCRIPT], cwd=copy, capture_output=True,
                          text=True, timeout=600, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    after = _digests(copy / "portbench")
    return json.loads(done.stdout.strip().splitlines()[-1]), before, after


def test_new_reference_and_drive_decide_correct(toy_run):
    out, _, _ = toy_run
    assert out["toy.ok"]["correct"] is True, out["toy.ok"]
    assert out["toy.ok"]["metrics"] == ["setup_s", "toy_fields_per_s"]
    # every answer 0.01 px off: the toy reference, found by name, says so
    assert out["toy.off"]["correct"] is False, out["toy.off"]
    assert out["toy.off"]["check"]["uv_gap_p99_px"]["value"] == pytest.approx(0.01, rel=1e-3)


def test_no_file_of_the_copy_changed(toy_run):
    _, before, after = toy_run
    assert {k: after[k] for k in before} == before
    added = set(after) - set(before)
    assert added == set(FILES) | {f"limits/{n}.json" for n in CELLS}


def test_unknown_names_stop_before_set_up(toy_run):
    out, _, _ = toy_run
    assert out["toy.noref"] == "no reference 'nosuch': the references present are ['piv', 'toy']"
    assert out["toy.nodrive"] == ("no drive 'nosuch': the drives present are "
                                  "['folder', 'staged', 'toydrive']")
    # ``check`` is a module of lib/, but says nothing of being a drive
    assert out["toy.check"] == ("no drive 'check': the drives present are "
                                "['folder', 'staged', 'toydrive']")


@pytest.mark.parametrize("name", ["check", "trace", "cell", "frames", "nosuch", "../lib/staged",
                                  "staged.py"])
def test_only_a_marked_module_is_a_drive(name):
    with pytest.raises(SystemExit, match=r"the drives present are \['folder', 'staged'\]"):
        cellmod.load_drive(name)


@pytest.mark.parametrize("name", ["staged", "folder"])
def test_the_drives_present(name):
    mod = cellmod.load_drive(name)
    assert mod.DRIVE is True
    assert all(callable(getattr(mod, f)) for f in ("setup", "window", "teardown"))


@pytest.mark.parametrize("name", ["nosuch", "__init__", "../lib/cell"])
def test_unknown_reference(name):
    with pytest.raises(SystemExit, match=r"the references present are \['piv'\]"):
        cellmod.load_reference(name)
