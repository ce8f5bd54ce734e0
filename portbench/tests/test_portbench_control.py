"""The control (the reference in TF32 put in the program's place) comes out
not correct under each cell's limits, and the program correct, both read
from a short window of the cell's drive, at a size the CPU holds.  On the
card ``portbench/control.py`` reads both at the cells' own size."""
from __future__ import annotations

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.control import readings  # noqa: E402
from portbench.lib.cell import Cell  # noqa: E402
from portbench.lib.check import judge  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
WINDOW_S = 8.0  # long enough for a few batches of the small cell on a loaded CPU


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_passes(name):
    cell = Cell(name, BENCH)
    cell.shrink((192, 192), 8, 4, 4)
    limits = cell.limits["limits"]
    r = readings(cell, 2**31 + 5, torch.device("cpu"), seconds=WINDOW_S)
    prog = {k: v for k, v in r["program"].items() if k in limits}
    ctrl = {k: v for k, v in r["control"].items() if k in limits}
    assert len(r["pairs"]) == 4
    assert judge(prog, limits, 4, 4)[0], r["program"]
    assert not judge(ctrl, limits, 4, 4)[0], r["control"]
