"""``tools/degraded_campaign_cuda.py`` on the CPU against
``tools/degraded_campaign.py``.

On one folder of 3 pairs at 256x256 per tier (written by the port's
``make_dataset``; the generators are equal to the JAX package's, see
``tests/test_torch_degraded.py``), every row of the campaign runs through
the port's ``run_ours`` with ``use_pallas="off"`` and through the JAX
tool's ``run_ours`` (which runs ``device="cpu"``, where the JAX pipeline
pins the same XLA path): the same pairs yielded, ``bad_pct`` equal, and
the two RMS columns within 1e-3 px (fields in px: dt 1000 us, scale 1
mm/px; both NaN where no pair is yielded).  ``main`` writes
``<tier>.json`` and ``<tier>.md`` only under the ``--out-dir`` it is
given.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SIZE = 256
N_PAIRS = 3


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return (_load("tools/degraded_campaign.py", "jax_degraded_campaign"),
            _load("tools/degraded_campaign_cuda.py", "port_degraded_campaign"))


@pytest.fixture(scope="module")
def folders(tools, tmp_path_factory):
    _, port = tools
    out = {}
    for tier in port.TIERS:
        out[tier] = str(tmp_path_factory.mktemp(tier))
        port.make_dataset(out[tier], SIZE, N_PAIRS, tier)
    return out


def test_settings_are_the_jax_tools(tools):
    jax_tool, port = tools
    assert port.TIERS == jax_tool.TIERS
    assert (port.TRUE_U, port.TRUE_V) == (jax_tool.TRUE_U, jax_tool.TRUE_V)
    fields = [(None, None, np.full((4, 4), 3.3), np.full((4, 4), 2.1)),
              (None, None, np.full((4, 4), 5.0), np.full((4, 4), 2.0))]
    assert port.field_metrics(fields) == jax_tool.field_metrics(fields)


@pytest.mark.parametrize("tier", ["moderate", "harsh"])
@pytest.mark.parametrize("row", [0, 1, 2, 3, 4, 5])
def test_rows_match_jax(tools, folders, tier, row):
    jax_tool, port = tools
    name, extra = port.CONFIGS[row]
    got = port.run_ours(folders[tier], "cpu", "off", **extra)
    want = jax_tool.run_ours(folders[tier], **extra)
    assert got["pairs_yielded"] == want["pairs_yielded"], name
    assert got["bad_pct"] == want["bad_pct"], name
    for key in ("rms_good_px", "rms_all_px"):  # NaN where no pair was yielded
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3,
                                   equal_nan=True, err_msg=f"{name} {key}")


def test_main_writes_only_under_its_out_dir(tools, tmp_path, capsys):
    _, port = tools
    out = tmp_path / "campaign"
    assert port.main(["--device", "cpu", "--size", "128", "--pairs", "2",
                      "--tier", "all", "--out-dir", str(out)]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "harsh.json", "harsh.md", "moderate.json", "moderate.md"]
    payload = json.loads((out / "moderate.json").read_text())
    assert payload["tier"] == "moderate" and payload["size"] == 128
    assert list(payload["rows"]) == [name for name, _ in port.CONFIGS]
    printed = capsys.readouterr().out
    assert printed.splitlines()[0] == "cpu"
    assert "| tpiv SCC (same settings) | 2 |" in printed
    assert port.OUT_DIR.endswith("docs/campaign_cuda")
