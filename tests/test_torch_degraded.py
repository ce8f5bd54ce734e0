"""The camera-degraded generators and the degraded-data campaign on the
port, against the JAX package on the same seeds.

* ``static_background``, ``camera_degraded_pair`` (both tiers of
  ``tools/degraded_campaign.py``, a seeding gradient, a callable flow) and
  ``contaminated_pair``: exactly equal to the JAX package's (numpy and
  scipy in both).
* ``OfflinePIV(device="cpu", engine_options={"use_pallas": "off", ...})``
  against the JAX ``OfflinePIV(device="cpu")`` (which pins
  ``use_pallas="off"``: the XLA paths) on a 3-pair 256x256 harsh-tier
  folder, with SCC, RPC and the second-peak fallback: the same pairs
  yielded (the >50%-invalid skip) and fields within the port's parity
  budget, read on the infilled fields the pipeline yields (it gives no
  mask): at most 2% of the components more than 0.01 px apart (the mask
  mismatch) and RMS < 0.01 px over the rest (physical units are px here:
  dt = 1000 us, scale = 1 mm/px).
* The campaign's qualitative pins (``tests/test_degraded_campaign.py``) on
  the port: the moderate tier yields every pair with no bad vectors and
  RMS(good) < 0.3 px; on the harsh tier RPC and the fallback each yield
  more pairs than SCC, and their fields stay measurements.
"""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

from torchpiv_tpu.pipeline import OfflinePIV as JaxOfflinePIV
from torchpiv_tpu.utils import synthetic as jax_synthetic
from torchpiv_tpu_torch.io.decode import imwrite_gray
from torchpiv_tpu_torch.pipeline import OfflinePIV
from torchpiv_tpu_torch.utils import synthetic

REPO = Path(__file__).resolve().parents[1]
SIZE = 256
# the campaign's settings (tools/degraded_campaign.py:130-142)
RUN = dict(file_fmt=".bmp", wind_size=64, overlap=32, multipass=2,
           multipass_mode="CWS", dt=1000.0, scale=1.0, folder_mode="pairs",
           device="cpu")
MODES = {"scc": {}, "rpc": {"correlation": "rpc"},
         "fallback": {"second_peak_fallback": True}}


@pytest.fixture(scope="module")
def dc():
    """``tools/degraded_campaign.py``: its tiers and ``field_metrics``."""
    spec = importlib.util.spec_from_file_location(
        "degraded_campaign", REPO / "tools" / "degraded_campaign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _make(folder, dc, tier, n_pairs):
    """The campaign's dataset, written with the port's generator."""
    os.makedirs(folder, exist_ok=True)
    for i in range(n_pairs):
        fa, fb = synthetic.camera_degraded_pair(
            (SIZE, SIZE), displacement=(dc.TRUE_U, dc.TRUE_V), seed=100 + i,
            **dc.TIERS[tier])
        imwrite_gray(os.path.join(folder, f"d{i:03d}_a.bmp"), fa)
        imwrite_gray(os.path.join(folder, f"d{i:03d}_b.bmp"), fb)
    return folder


@pytest.fixture(scope="module")
def harsh(dc, tmp_path_factory):
    return _make(str(tmp_path_factory.mktemp("harsh")), dc, "harsh", 3)


def _port_fields(folder, **engine_options):
    piv = OfflinePIV(folder, engine_options={"use_pallas": "off", **engine_options},
                     **RUN)
    return list(piv())


@pytest.mark.parametrize("tier", ["moderate", "harsh"])
@pytest.mark.parametrize("seed", [0, 5])
def test_camera_degraded_pair_equals_jax(dc, tier, seed):
    kw = dict(displacement=(3.3, -2.1), seed=seed, **dc.TIERS[tier])
    for got, want in zip(synthetic.camera_degraded_pair((96, 128), **kw),
                         jax_synthetic.camera_degraded_pair((96, 128), **kw)):
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_degraded_options_equal_jax():
    """The seeding gradient, a callable flow, no shot noise."""
    flow = synthetic.shear_flow(1.0, 0.02)
    kw = dict(displacement=flow, seeding_gradient=0.6, shot_noise=False, seed=3)
    for got, want in zip(synthetic.camera_degraded_pair((80, 64), **kw),
                         jax_synthetic.camera_degraded_pair((80, 64), **kw)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="seeding_gradient"):
        synthetic.camera_degraded_pair((32, 32), seeding_gradient=1.0)


def test_background_and_contaminated_pair_equal_jax():
    got = synthetic.static_background((70, 90), 45.0, seed=4, smoothness=9)
    want = jax_synthetic.static_background((70, 90), 45.0, seed=4, smoothness=9)
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0.0
    for got, want in zip(synthetic.contaminated_pair((64, 96), (1.5, 0.5), 60.0, seed=2,
                                                     density=0.03),
                         jax_synthetic.contaminated_pair((64, 96), (1.5, 0.5), 60.0,
                                                         seed=2, density=0.03)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_harsh_tier_matches_jax_offline_piv(harsh, mode):
    want = list(JaxOfflinePIV(harsh, engine_options=MODES[mode] or None, **RUN)())
    got = _port_fields(harsh, **MODES[mode])
    assert len(got) == len(want)
    for (x, y, u, v), (jx, jy, ju, jv) in zip(got, want):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        d = np.concatenate([(u - ju).ravel(), (v - jv).ravel()]).astype(np.float64)
        assert np.mean(np.abs(d) > 0.01) < 0.02
        assert np.sqrt(np.mean(d[np.abs(d) <= 0.01] ** 2)) < 0.01


def test_moderate_tier_accuracy_floor(dc, tmp_path):
    m = dc.field_metrics(_port_fields(_make(str(tmp_path), dc, "moderate", 2)))
    assert m["pairs_yielded"] == 2
    assert m["bad_pct"] < 1.0
    assert m["rms_good_px"] < 0.3


def test_harsh_tier_recovery_modes_yield_more_pairs(dc, harsh):
    scc, rpc, spf = (dc.field_metrics(_port_fields(harsh, **MODES[m]))
                     for m in ("scc", "rpc", "fallback"))
    assert scc["pairs_yielded"] <= 1, scc
    assert spf["pairs_yielded"] > scc["pairs_yielded"], (scc, spf)
    assert rpc["pairs_yielded"] > scc["pairs_yielded"], (scc, rpc)
    assert spf["rms_all_px"] < 1.0, spf
    assert rpc["rms_good_px"] < 0.5, rpc
