"""A run's last line, the no-JAX check, and a run with the timed path
broken underneath, at a size the CPU holds (``Cell.shrink``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib import cell as cellmod  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = dict(frame_shape=(192, 192), unique_pairs=8, batch=4, check_pairs=3)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
WINDOW_S = 2.0  # a few batches of the small dense cell on a share of this CPU


@pytest.fixture(autouse=True)
def own_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))


def run(name, traced=False, seed=2**31 + 11):
    return cellmod.run(name, seed, WINDOW_S, traced, torch.device("cpu"),
                       time.perf_counter(), BENCH, shrink=SMALL)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(name, traced):
    line = run(name, traced)
    keys = KEYS + (["breakdown"] if traced else []) + ["check"]
    assert list(line) == keys
    assert line["correct"] is True
    assert line["attempted"] >= line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    c = cellmod.Cell(name, BENCH)
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    # a traced CPU run has no device events: those metrics stay out
    assert set(line["metrics"]) <= want
    if not traced:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())
    json.dumps(line)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    fake = dict(sys.modules)
    fake.update({"torchpiv_tpu_torch": None, "torchpiv_tpu_torch.pipeline": None,
                 "jaxtyping": None})
    fake = {k: v for k, v in fake.items() if k.split(".")[0] not in cellmod.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", fake)
    assert cellmod.forbidden_modules() == []
    fake["torchpiv_tpu.pipeline"] = None
    fake["jax.numpy"] = None
    assert cellmod.forbidden_modules() == ["jax", "torchpiv_tpu"]


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.lib.cell, portbench.lib.staged, portbench.lib.folder\n"
            "import portbench.lib.check, portbench.lib.trace, portbench.control\n"
            "import torchpiv_tpu_torch.pipeline, torchpiv_tpu_torch.models.multipass\n"
            "from portbench.lib.cell import forbidden_modules\n"
            "print(forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _stale(real):
    last = {}

    def forward(engine, a, b):
        out = real(engine, a, b)
        prev = last.get("out")
        last["out"] = out
        return prev if prev is not None and prev.shape == out.shape else out
    return forward


def _half_batch(real):
    def forward(engine, a, b):
        h = -(-a.shape[0] // 2)
        out = real(engine, a[:h], b[:h])
        return torch.cat([out, out[:a.shape[0] - h]])
    return forward


def _altered(real):
    def forward(engine, a, b):
        out = real(engine, a, b).clone()
        out[:, 0] += 0.01  # every field's u, by a hundredth of a pixel
        return out
    return forward


def _block_altered(real):
    def forward(engine, a, b):
        out = real(engine, a, b).clone()
        R, C = out.shape[-2:]
        k = max(1, R * C // 200)  # half a percent of each field's vectors,
        u = out[:, 0].reshape(out.shape[0], -1)  # by a pixel: p99 passes
        u[:, (R * C - k) // 2:(R * C + k) // 2] += 1.0
        out[:, 0] = u.reshape(out.shape[0], R, C)
        return out
    return forward


FAULTS = {"state_unchanged": _stale, "half_batch_left_out": _half_batch,
          "answer_altered": _altered, "block_altered": _block_altered}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(name, fault, monkeypatch):
    import torchpiv_tpu_torch.pipeline as pipeline

    monkeypatch.setattr(pipeline, "packed_forward", FAULTS[fault](pipeline.packed_forward))
    line = run(name, seed=2**31 + 23)
    assert line["correct"] is False, line["check"]
    if fault == "block_altered":
        assert line["check"]["uv_gap_p99_px"]["value"] <= line["check"]["uv_gap_p99_px"]["limit"]


@pytest.mark.cuda
def test_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "7", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "7", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("margin,where", [(0.0, "warm-up"), (0.2, "before the window")])
def test_folder_that_runs_dry_raises(monkeypatch, margin, where):
    """8 names run out in the warm-up (12 fields); 14 in the window."""
    from portbench.lib import folder

    monkeypatch.setattr(folder, "LINK_MARGIN", margin)
    monkeypatch.setattr(folder, "LINK_SLACK_S", 0)
    monkeypatch.setattr(folder, "engine_pace", lambda cell, device: 1.0)
    with pytest.raises(RuntimeError, match=f"ran out.*{where}"):
        cellmod.run("cws64.folder", 2**31 + 5, 30.0, False, torch.device("cpu"),
                    time.perf_counter(), BENCH, shrink=SMALL)


def test_folder_setup_leaves_out_the_harness_write(monkeypatch):
    """``setup_s`` is the time to the window's opening less the folder's
    writing (``harness_s``), here made at least ``SLEEP_S`` long."""
    from portbench.lib import folder

    SLEEP_S = 2.0
    real_write, real_window = folder.write_folder, folder.window
    seen = {}

    def slow_write(*args, **kw):
        time.sleep(SLEEP_S)
        return real_write(*args, **kw)

    def window(*args, **kw):
        out = real_window(*args, **kw)
        seen.update(t0=out["t0"], harness_s=out["harness_s"])
        return out

    monkeypatch.setattr(folder, "write_folder", slow_write)
    monkeypatch.setattr(folder, "window", window)
    # names enough for the window at any pace this CPU reaches
    monkeypatch.setattr(folder, "engine_pace", lambda cell, device: 50.0)
    t_start = time.perf_counter()
    line = cellmod.run("cws64.folder", 2**31 + 29, 1.0, False, torch.device("cpu"),
                       t_start, BENCH, shrink=SMALL)
    assert seen["harness_s"] >= SLEEP_S
    setup_s = line["metrics"]["setup_s"]["value"]
    assert setup_s == pytest.approx(seen["t0"] - t_start - seen["harness_s"], abs=1e-9)
    assert 0 < setup_s < seen["t0"] - t_start - SLEEP_S
