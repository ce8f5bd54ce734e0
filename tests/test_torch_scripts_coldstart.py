"""``tools/coldstart_cuda.py`` on the CPU, in a fresh interpreter with an
empty build cache (``TORCHPIV_CACHE_DIR``), over a small folder made first
with the tool's ``make_dataset`` (6 pairs of 256x256, ``COLDSTART_BATCH``
4): it prints the device line and then one JSON line with the JAX tool's
keys (``time_to_first_field_s``, ``first_batch_s``, ``engine_build_s``,
``n_pairs``, ``total_s``) and the split of the time to first field, whose
parts are non-negative and sum to no more than the total; no kernel loads
on the CPU, and the native decoder was built into the empty cache.

A folder that holds anything is timed as it is and left untouched, pair
count and foreign files alike; ``make_dataset`` makes pairs only in a
missing or empty folder, the rest of them hard links to the first four.
Without a card and without ``--device cpu`` it fails naming
``device='cpu'``.  ``kernels/_build.load_log``, which the tool reads,
records each source's first load once, built or found in the build
directory (a C source built by ``gcc`` stands in for ``nvcc`` here).
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from torchpiv_tpu_torch.kernels import _build

REPO = Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "coldstart_cuda.py"
PARTS = ("imports_s", "card_init_s", "decoder_load_s", "engine_build_s", "first_batch_s")


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("port_coldstart", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(tmp_path, *args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "TPIV_DEVICE"}
    env.update(TORCHPIV_CACHE_DIR=str(tmp_path / "cache"), COLDSTART_BATCH="4",
               **(env_extra or {}))
    return subprocess.run(
        [sys.executable, str(TOOL), "--folder", str(tmp_path / "pairs"), *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def _snapshot(folder: Path) -> dict:
    return {p.name: (p.stat().st_ino, p.stat().st_mtime_ns, p.read_bytes())
            for p in sorted(folder.iterdir())}


def test_cold_run_on_the_cpu(tool, tmp_path):
    tool.make_dataset(str(tmp_path / "pairs"), 6, (256, 256))
    proc = _run(tmp_path, "--device", "cpu", "--use-pallas", "off")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "cpu"
    out = json.loads(lines[-1])
    assert out["metric"] == "time_to_first_field_s" and out["unit"] == "s"
    for key in ("value", "first_batch_s", "engine_build_s", "n_pairs", "total_s", "parts"):
        assert key in out
    assert out["n_pairs"] == 6
    parts = out["parts"]
    for key in PARTS:
        assert parts[key] >= 0.0
    assert sum(parts[k] for k in PARTS) <= out["value"] + 1e-3 <= out["total_s"] + 2e-3
    assert abs(parts["imports_s"] - parts["import_torch_s"] - parts["import_port_s"]) < 1e-3
    assert out["kernel_load_s"] == 0.0 and out["kernel_loads"] == {}
    assert out["first_batch_spans"]["pairs"] == 4
    assert out["cache_dir"] == str((tmp_path / "cache").resolve())
    assert out["native_decoder"] == any((tmp_path / "cache").glob("libfastio-*.so"))


def test_a_named_folder_is_timed_as_it_is_and_left_untouched(tool, tmp_path):
    folder = tmp_path / "pairs"
    tool.make_dataset(str(folder), 3, (128, 128))  # 3 pairs, not the 48 it would make
    (folder / "notes.txt").write_text("a recording's notes\n")
    before = _snapshot(folder)
    proc = _run(tmp_path, "--device", "cpu", "--use-pallas", "off")
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["n_pairs"] == 3
    assert _snapshot(folder) == before


def test_make_dataset_only_in_a_missing_or_empty_folder(tool, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    tool.make_dataset(str(empty), 6, (64, 64))
    names = sorted(p.name for p in empty.iterdir())
    assert names == sorted(f"p{i:04d}_{k}.bmp" for i in range(6) for k in "ab")
    assert (empty / "p0005_a.bmp").stat().st_ino == (empty / "p0001_a.bmp").stat().st_ino
    assert not list(tmp_path.glob("*.partial"))
    before = _snapshot(empty)
    with pytest.raises(FileExistsError):
        tool.make_dataset(str(empty), 2, (64, 64))
    assert tool.ensure_dataset(str(empty), 2) == 0.0
    assert _snapshot(empty) == before


def test_without_a_card_it_names_the_cpu(tool, tmp_path):
    tool.make_dataset(str(tmp_path / "pairs"), 2, (64, 64))
    proc = _run(tmp_path, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not proc.stdout.strip()


def test_load_log_records_each_first_load(tmp_path, monkeypatch):
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.fail("no C compiler to stand in for nvcc")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stand_in.cu").write_text("int stand_in_answer(void) { return 42; }\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "NVCC_FLAGS", ("-x", "c", "-shared", "-fPIC"))
    monkeypatch.setattr(_build, "_nvcc", lambda: cc)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "cache")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_load_log", {})
    assert _build.load("stand_in").stand_in_answer() == 42
    _build.load("stand_in")
    first = _build.load_log()
    assert list(first) == ["stand_in"] and first["stand_in"]["built"] is True
    assert first["stand_in"]["s"] > 0.0
    monkeypatch.setattr(_build, "_loaded", {})  # a fresh process over the same cache
    monkeypatch.setattr(_build, "_load_log", {})
    _build.load("stand_in")
    assert _build.load_log()["stand_in"]["built"] is False
