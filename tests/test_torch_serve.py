"""The port's HTTP service with the port's client on the CPU: the round
trip, server-readable files, health, config and metrics, the error paths,
a burst with a skipped pair in two engine calls (``TPIV_SERVE_SCAN_B=2``,
the last one short) and warmup; the JAX package's ``PIVClient`` against the
port's server (the same wire format); fields held against the JAX
``PIVService`` (running the interpreted Pallas kernels).

Tolerance, as in ``test_torch_pipeline.py``: ``x`` and ``y`` equal, ``u, v``
within RMS 0.01 px and fewer than 2% of the components more than 0.01 px
apart, and fewer than 2% of the windows with another invalid flag."""
import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from torchpiv_tpu.client import PIVClient as JaxPIVClient
from torchpiv_tpu.serve import PIVService as JaxPIVService
from torchpiv_tpu_torch.client import PIVClient, PIVServerError
from torchpiv_tpu_torch.io.decode import imwrite_gray
from torchpiv_tpu_torch.serve import PIVService, make_server
from torchpiv_tpu_torch.utils.synthetic import particle_pair

SETTINGS = dict(wind_size=32, overlap=16, multipass=2, dt=2.0, scale=0.05)
UNIT = 0.05 / 2.0 * 1000  # px -> output units
SHAPE = (128, 128)
FA, FB = particle_pair(SHAPE, (2.0, 1.0), seed=12)
FA2, FB2 = particle_pair(SHAPE, (-1.5, 0.5), seed=13)
BLANK = np.zeros(SHAPE, np.uint8)  # every window degenerate: skipped
BURST_A = np.stack([FA, BLANK, FA2])
BURST_B = np.stack([FB, BLANK, FB2])


def _scan_b(value):
    """``TPIV_SERVE_SCAN_B`` set while a service is built."""
    old = os.environ.get("TPIV_SERVE_SCAN_B")
    os.environ["TPIV_SERVE_SCAN_B"] = value
    return old


@pytest.fixture(scope="module")
def server():
    old = _scan_b("2")
    try:
        service = PIVService(device="cpu", **SETTINGS)
    finally:
        if old is None:
            del os.environ["TPIV_SERVE_SCAN_B"]
        else:
            os.environ["TPIV_SERVE_SCAN_B"] = old
    assert service._scan_b == 2
    srv = make_server(service, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address
    yield f"http://{host}:{port}", service
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


@pytest.fixture(scope="module")
def jax_answers():
    service = JaxPIVService(device="cpu", engine_options={
        "use_pallas": "on", "pallas_interpret": True}, **SETTINGS)
    return service.analyze(FA, FB), service.analyze_batch(BURST_A, BURST_B)


def _close(x, y, u, v, invalid, want):
    np.testing.assert_array_equal(x, want["x"])
    np.testing.assert_array_equal(y, want["y"])
    for a, b in ((u, want["u"]), (v, want["v"])):
        assert np.isfinite(a).all()
        d = np.abs(a - b) / UNIT
        assert np.sqrt(np.mean(d ** 2)) < 0.01
        assert (d > 0.01).mean() < 0.02
    assert invalid.dtype == np.bool_
    assert (invalid != want["invalid"]).mean() < 0.02


def test_round_trip_matches_jax_service(server, jax_answers):
    base, service = server
    c = PIVClient(base)
    n0 = service.pairs_served
    _close(*c.analyze(FA, FB), jax_answers[0])
    assert service.pairs_served == n0 + 1
    assert list(service._engines) == [SHAPE]
    # the JAX package's client reads the same wire format
    got = JaxPIVClient(base).analyze(FA, FB)
    for a, b in zip(got, c.analyze(FA, FB)):
        np.testing.assert_array_equal(a, b)


def test_files_health_config_metrics(server, tmp_path):
    base, _ = server
    c = PIVClient(base)
    pa, pb = str(tmp_path / "a.bmp"), str(tmp_path / "b.bmp")
    imwrite_gray(pa, FA)
    imwrite_gray(pb, FB)
    for a, b in zip(c.analyze_files(pa, pb), c.analyze(FA, FB)):
        np.testing.assert_array_equal(a, b)
    h = c.health()
    assert h["ok"] and list(SHAPE) in h["compiled_shapes"] and h["device"] == "cpu"
    cfg = c.config()
    assert cfg["wind_size"] == 32 and cfg["multipass"] == 2 and cfg["dt"] == 2.0
    text = c.metrics()
    assert "tpiv_pairs_served" in text and "tpiv_latency_ms_p95" in text
    assert JaxPIVClient(base).health()["compiled_shapes"] == h["compiled_shapes"]


def _post(url, body, ctype="application/octet-stream"):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("path,body,ctype,code", [
    ("/piv", b"not an npz", "application/octet-stream", 400),
    ("/piv", _npz(q=np.zeros((8, 8))), "application/octet-stream", 400),
    ("/piv", _npz(a=np.zeros((64, 64), np.uint8), b=np.zeros((64, 32), np.uint8)),
     "application/octet-stream", 400),
    ("/piv", _npz(a=BURST_A, b=BURST_B[:2]), "application/octet-stream", 400),
    ("/piv_files", json.dumps({"a": "/no/such.bmp", "b": "x"}).encode(),
     "application/json", 400),
    ("/nope", b"{}", "application/json", 404),
])
def test_error_paths(server, path, body, ctype, code):
    base, service = server
    errors = service.errors
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + path, body, ctype)
    assert ei.value.code == code
    assert service.errors == errors + (code == 400)


def test_burst_with_a_skipped_pair_matches_jax_service(server, jax_answers):
    base, _ = server
    c = PIVClient(base)
    want = jax_answers[1]
    got = c.analyze_burst(BURST_A, BURST_B)
    assert list(got["skipped_pairs"]) == list(want["skipped_pairs"]) == [False, True, False]
    assert got["u"].shape == (3, *got["x"].shape)
    assert np.isnan(got["u"][1]).all() and got["invalid"][1].all()
    for i in (0, 2):
        _close(got["x"], got["y"], got["u"][i], got["v"][i], got["invalid"][i],
               {"x": want["x"], "y": want["y"], "u": want["u"][i],
                "v": want["v"][i], "invalid": want["invalid"][i]})
    # the first pair of the burst equals the single-pair answer
    single = c.analyze(FA, FB)
    np.testing.assert_allclose(got["u"][0], single[2], rtol=0, atol=1e-4)
    # every pair skipped: 422, and None from the client
    assert c.analyze_burst(BURST_A[1:2], BURST_B[1:2]) is None
    assert c.analyze(BLANK, BLANK) is None
    with pytest.raises(PIVServerError) as ei:
        c.analyze(FA, FB[:64])
    assert ei.value.status == 400
    with pytest.raises(ValueError):
        c.analyze_burst(FA, FB)  # not stacked


def test_warmup_builds_and_runs_both_paths():
    service = PIVService(device="cpu", **SETTINGS)
    service.warmup((96, 96))
    assert list(service._engines) == [(96, 96)]
    assert service.pairs_served == 1  # the single-pair path, as in JAX
