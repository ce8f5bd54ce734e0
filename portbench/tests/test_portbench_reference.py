"""The plain reference recovers a known displacement, and its pieces do
what their docstrings say."""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib import frames  # noqa: E402
from portbench.reference import piv  # noqa: E402

UNIFORM = {"drive": "staged", "unique_pairs": 1,
           "particles": {"density": 0.02, "diameter": 2.5, "noise": 2.0,
                         "background": 8.0},
           "flow": {"uniform": [3.3, -2.1]}}


@pytest.mark.parametrize("mode,w,o,passes", [("CWS", 32, 16, 2), ("DEF", 32, 16, 2)])
def test_uniform_displacement_recovered(mode, w, o, passes):
    a, b = frames.pairs(1, (192, 192), UNIFORM, 3, "cpu")
    cfg = {"frame_shape": [192, 192], "wind_size": w, "overlap": o,
           "multipass": passes, "multipass_mode": mode}
    (x, y, u, v), inval = piv.run(a[0], b[0], cfg)
    assert inval.mean() < 0.05
    inner = (slice(2, -2), slice(2, -2))
    # units: px * scale / dt * 1000; the tail flips the y axis
    assert abs(np.median(u[inner]) / 1000 - 3.3) < 0.05
    assert abs(np.median(v[inner]) / 1000 - 2.1) < 0.05


def test_correlation_peak_at_the_shift():
    g = torch.Generator().manual_seed(0)
    a = torch.rand((3, 16, 16), generator=g, dtype=torch.float64)
    b = torch.roll(a, shifts=(2, -3), dims=(-2, -1))
    c = piv.correlate(piv.Arith("float64"), a, b)
    u, v, inval = piv.peak_fit(c, 1.2, 3)
    assert torch.allclose(u, torch.full_like(u, -3.0), atol=0.3)
    assert torch.allclose(v, torch.full_like(v, 2.0), atol=0.3)
    flat = c.reshape(3, -1).argmax(dim=1)
    assert torch.equal(flat // 16 - 8, torch.full((3,), 2))
    assert torch.equal(flat % 16 - 8, torch.full((3,), -3))
    assert not inval.any()


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0], dtype=torch.float32)
    r = piv._tf32(x)
    assert r[0] == 1.0 + 2**-10  # a tie, away from zero
    assert r[1] == 1.0 + 2**-10
    assert r[2] == -3.0


def test_tail_infills_and_flips():
    cfg = {"frame_shape": [64, 64], "wind_size": 16, "overlap": 8}
    u = torch.ones((7, 7), dtype=torch.float64)
    v = torch.arange(7, dtype=torch.float64)[:, None].expand(7, 7).clone()
    inval = torch.zeros((7, 7), dtype=torch.bool)
    inval[3, 3] = True
    x, y, uu, vv = piv.tail(u, v, inval, cfg)
    assert np.allclose(uu, 1000.0)
    assert np.allclose(vv, -1000.0 * np.arange(7)[::-1, None])
    assert x.shape == (7, 7) and x[0, 0] == 8.0 + (63 - (6 * 8 + 15)) // 2


REFUSED = [("multipass_mode", "DWS"), ("cws_interp", "bicubic"), ("correlation", "rpc"),
           ("subpixel", "gauss2d"), ("window_weight", "gaussian"),
           ("median_filter", "normmedian"), ("u_limits", [-5, 5]), ("v_limits", [-5, 5]),
           ("global_std", 3.0), ("second_peak_fallback", True), ("validate", False),
           ("infill", "fused"), ("edge_exact", False), ("dtype", "bfloat16"),
           ("no_such_key", 1)]
PASSED = [("fused", "split"), ("peakfit", "pallas"), ("correlator", "matmul"),
          ("dft_precision", "default"), ("use_pallas", "off"), ("shift_variant", "bf16"),
          ("dtype", "float32"), ("correlation", "scc"), ("multipass_mode", "DEF")]
BASE = {"frame_shape": [64, 64], "wind_size": 16, "overlap": 8}


@pytest.mark.parametrize("key,value", REFUSED)
def test_refuses_semantics_it_does_not_compute(key, value):
    with pytest.raises(ValueError, match=key):
        piv.settings({**BASE, key: value})


@pytest.mark.parametrize("key,value", PASSED)
def test_implementation_choices_pass(key, value):
    assert piv.settings({**BASE, key: value})[key] == value


@pytest.mark.parametrize("name", ["cws64", "def_dense"])
def test_the_configurations_pass(name):
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")))
    assert cfg.get("reference", "piv") == "piv"
    piv.settings({**cfg["engine"], "frame_shape": cfg["frame_shape"]})
