"""Every entry of ``BENCHMARK.json`` resolves to its files under
``portbench/``, and the file keeps the contract's shape."""
from __future__ import annotations

import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib.cell import Cell, load_metric  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    data = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    # a public URL, or a paper cited with its year
    assert data["source"] == cfg["source"]
    assert cfg["source"].startswith("https://") or re.search(r"\b(19|20)\d\d\b", cfg["source"])
    assert 1 <= len(cfg["source"]) <= 200 and "\n" not in cfg["source"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200
    c = Cell(cell["name"], BENCH)
    assert c.drive.DRIVE is True and c.reference is not None
    assert c.traffic["unique_pairs"] % c.config["batch"] == 0
    assert set(c.limits["limits"]) >= {"xy_gap_px", "skip_mismatch", "uv_gap_p99_px"}
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer


def test_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    mod = load_metric(metric["name"])
    assert callable(mod.read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        for cell in metric.get("workloads", cells):
            assert cell in e2e[metric["moves"]].get("workloads", cells)
