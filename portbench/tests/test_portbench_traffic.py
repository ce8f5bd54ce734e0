"""The traffic generator is deterministic per seed, and every seed gives
the same amount of work."""
from __future__ import annotations

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib import frames  # noqa: E402

MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "portbench", "traffic")))


def mix(name):
    return json.load(open(os.path.join(ROOT, "portbench", "traffic", f"{name}.json")))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_bytes(name):
    a1, b1 = frames.pairs(2, (96, 128), mix(name), 2**31 + 7, "cpu")
    a2, b2 = frames.pairs(2, (96, 128), mix(name), 2**31 + 7, "cpu")
    assert a1.dtype == torch.uint8 and a1.shape == (2, 96, 128)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_bytes(name):
    a1, _ = frames.pairs(1, (96, 128), mix(name), 5, "cpu")
    a2, _ = frames.pairs(1, (96, 128), mix(name), 6, "cpu")
    assert not torch.equal(a1, a2)


def test_flow_is_the_uniform_plus_the_vortex():
    f = mix("staged")["flow"]
    centre = torch.tensor([[500.0, 400.0]], dtype=torch.float64)
    xs = torch.tensor([[500.0 + 1.12091 * 256.0, 10000.0]], dtype=torch.float64)
    ys = torch.tensor([[400.0, 400.0]], dtype=torch.float64)
    u, v = frames.flow(f, xs, ys, centre)
    # the largest swirl, pointing along +y at a point to the right of the centre
    assert abs(float(u[0, 0]) - 3.3) < 1e-9
    assert abs(float(v[0, 0]) - (-2.1 + 4.0)) < 1e-4
    # far away the uniform flow alone (the swirl decays as 1 / r)
    assert abs(float(u[0, 1]) - 3.3) < 1e-9 and abs(float(v[0, 1]) + 2.1) < 0.2
