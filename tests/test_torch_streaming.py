"""The port's streaming front ends on the CPU: ``DeviceMap``, ``OnlinePIV``
against the JAX ``OnlinePIV`` on pairs a camera thread brings in with
``os.replace`` (single pairs, a catch-up chunk, a non-uint8 preprocess, a
shape skip and a corrupt frame), the decode retry of a mid-write frame,
the ``frame_shape`` warm-up, the watcher's pairing rules in both packages,
``VideoPIV`` against the JAX ``VideoPIV`` in both pairing modes with a
short last batch, and the video stand-in of ``chip_smoke.py`` against
OpenCV.

The JAX entry points run their kernels' semantics through
``engine_options={"use_pallas": "on", "pallas_interpret": True}``.
Tolerance, as in ``test_torch_pipeline.py``: ``x`` and ``y`` equal, ``u, v``
within RMS 0.01 px and fewer than 2% of the components more than 0.01 px
apart.  No test asserts a rate or a latency: the camera-rate run is
``chip_smoke.py``'s."""
import importlib.util
import logging
import os
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from torchpiv_tpu.io.watch import StreamingPairSource as JaxStreamingPairSource
from torchpiv_tpu.pipeline import OnlinePIV as JaxOnlinePIV
from torchpiv_tpu.pipeline import VideoPIV as JaxVideoPIV
from torchpiv_tpu_torch import OfflinePIV, OnlinePIV, VideoPIV
from torchpiv_tpu_torch import pipeline
from torchpiv_tpu_torch.io.decode import imwrite_gray
from torchpiv_tpu_torch.io.watch import StreamingPairSource
from torchpiv_tpu_torch.pipeline import DeviceMap
from torchpiv_tpu_torch.utils.synthetic import particle_pair

REPO = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (128, 128)
KW = dict(file_fmt=".bmp", wind_size=32, overlap=16, multipass=2, dt=2.0,
          scale=0.05)
UNIT = 0.05 / 2.0 * 1000  # px -> output units
JAX_OPTIONS = {"use_pallas": "on", "pallas_interpret": True}


def _scaled(frame):
    """A preprocess that emits float32 frames."""
    return (frame * 0.731).astype(np.float32)


def _close(got, want):
    assert len(got) == len(want)
    for (ox, oy, ou, ov), (rx, ry, ru, rv) in zip(got, want):
        np.testing.assert_array_equal(ox, rx)
        np.testing.assert_array_equal(oy, ry)
        for a, b in ((ou, ru), (ov, rv)):
            assert np.isfinite(a).all()
            d = np.abs(np.asarray(a) - np.asarray(b)) / UNIT
            assert np.sqrt(np.mean(d ** 2)) < 0.01
            assert (d > 0.01).mean() < 0.02


def _put(folder, name, frame=None, raw=None):
    """Bring a frame into ``folder`` whole: written beside it, then renamed
    (``raw`` bytes instead of a frame: a corrupt file)."""
    staging = folder.parent / (folder.name + "-staging")
    staging.mkdir(exist_ok=True)
    tmp = staging / name
    if raw is not None:
        tmp.write_bytes(raw)
    else:
        imwrite_gray(str(tmp), frame)
    os.replace(tmp, folder / name)


def _pair(i, shape=SHAPE):
    return particle_pair(shape, (1.5 + 0.25 * i, -1.0), seed=60 + i)


def _put_pair(folder, i, shape=SHAPE, corrupt_b=False):
    fa, fb = _pair(i, shape)
    _put(folder, f"cam{i}_a.bmp", fa)
    if corrupt_b:
        _put(folder, f"cam{i}_b.bmp", raw=b"\x00\x01never-valid")
    else:
        _put(folder, f"cam{i}_b.bmp", fb)


def _stream(cls, folder, **kw):
    """A stream over the camera script: a burst of three pairs before the
    first poll, then, from a thread, two single pairs, a pair of another
    shape, a pair with a corrupt frame and a last pair; the stream ends
    when no pair arrives for 2 s."""
    folder.mkdir()
    piv = cls(str(folder), device="cpu", poll_interval=0.05, idle_timeout=2.0,
              catchup_batch=2, **KW, **kw)
    for i in range(3):
        _put_pair(folder, i)

    def camera():
        for i in (3, 4):
            time.sleep(0.4)
            _put_pair(folder, i)
        _put_pair(folder, 5, shape=(96, 128))
        _put_pair(folder, 6, corrupt_b=True)
        time.sleep(0.2)
        _put_pair(folder, 7)

    t = threading.Thread(target=camera)
    t.start()
    try:
        fields = list(piv())
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    return piv, fields


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    """The JAX ``OnlinePIV``'s fields over the camera script, float32
    frames through the catch-up and single-pair paths."""
    _, fields = _stream(JaxOnlinePIV, tmp_path_factory.mktemp("jax") / "cam",
                        preprocess=_scaled, engine_options=JAX_OPTIONS)
    return fields


def test_online_piv_matches_jax_online_piv(tmp_path, jax_stream):
    piv, got = _stream(OnlinePIV, tmp_path / "cam", preprocess=_scaled)
    # pairs 0-4 and 7: the pair of another shape and the corrupt one skip
    assert len(jax_stream) == 6
    _close(got, jax_stream)
    assert piv.dispatches["catchup"] >= 1 and piv.dispatches["single"] >= 1
    assert 2 * piv.dispatches["catchup"] + piv.dispatches["single"] == 6
    assert piv.engine.config.frame_shape == SHAPE


def test_online_piv_yields_offline_pivs_fields(tmp_path):
    """Five pairs before the first poll: two catch-up chunks and one single
    pair, the same fields as ``OfflinePIV`` over the same files."""
    cam = tmp_path / "cam"
    cam.mkdir()
    piv = OnlinePIV(str(cam), device="cpu", poll_interval=0.05, idle_timeout=1.0,
                    catchup_batch=2, **KW)
    for i in range(5):
        _put_pair(cam, i)
    got = list(piv())
    assert dict(piv.dispatches) == {"catchup": 2, "single": 1}
    want = list(OfflinePIV(str(cam), device="cpu", batch_size=2, **KW)())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_frame_shape_hint_warms_before_the_first_frame(tmp_path):
    piv = OnlinePIV(str(tmp_path), device="cpu", poll_interval=0.05,
                    idle_timeout=1.0, catchup_batch=3, frame_shape=SHAPE, **KW)
    assert piv.engine is None
    seen = []

    def camera():
        # no frame exists until the stream has warmed on its own
        deadline = time.monotonic() + 60
        while piv.dispatches["warm"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        seen.append(dict(piv.dispatches))
        _put_pair(tmp_path, 0, shape=(96, 128))  # not the hinted shape
        _put_pair(tmp_path, 1)

    t = threading.Thread(target=camera)
    t.start()
    fields = list(piv())
    t.join(timeout=30)
    assert seen == [{"warm": 2}]  # one call of each size, 1 and 3 pairs
    assert len(fields) == 1 and piv.dispatches["single"] == 1
    assert piv.engine.config.frame_shape == SHAPE


def test_online_fused_infill_matches_offline(tmp_path):
    """The tail gate of ``OfflinePIV``: with ``infill="fused"`` the device
    filled the invalid vectors, and the host neither NaNs them nor skips."""
    folder = tmp_path / "f"
    folder.mkdir()
    fa, fb = particle_pair(SHAPE, (2.0, 1.0), seed=31)
    rng = np.random.default_rng(3)
    fa[:, 96:] = rng.integers(0, 255, fa[:, 96:].shape, dtype=np.uint8)
    fb[:, 96:] = rng.integers(0, 255, fb[:, 96:].shape, dtype=np.uint8)
    imwrite_gray(str(folder / "c0_a.bmp"), fa)
    imwrite_gray(str(folder / "c0_b.bmp"), fb)
    kw = dict(device="cpu", file_fmt=".bmp", wind_size=32, overlap=16,
              engine_options={"infill": "fused"})
    off = list(OfflinePIV(str(folder), **kw)())
    piv = OnlinePIV(str(folder), poll_interval=0.05, idle_timeout=1.0, **kw)
    _put(folder, "c1_a.bmp", fa)
    _put(folder, "c1_b.bmp", fb)
    on = list(piv())
    assert len(on) == len(off) == 1  # c0 predates the stream
    np.testing.assert_allclose(on[0][2], off[0][2], atol=1e-5)
    np.testing.assert_allclose(on[0][3], off[0][3], atol=1e-5)


def test_online_piv_with_a_frame_mask_matches_offline(tmp_path):
    """``engine_options`` carries ``frame_mask`` and ``mask_threshold`` to
    the engine and its tail: masked windows at zero, as ``OfflinePIV``."""
    mask = np.zeros(SHAPE, bool)
    mask[:, :40] = True
    options = {"frame_mask": mask, "mask_threshold": 0.25}
    cam = tmp_path / "cam"
    cam.mkdir()
    piv = OnlinePIV(str(cam), device="cpu", poll_interval=0.05, idle_timeout=1.0,
                    catchup_batch=2, engine_options=options, **KW)
    for i in range(2):
        _put_pair(cam, i)
    got = list(piv())
    want = list(OfflinePIV(str(cam), device="cpu", batch_size=2,
                           engine_options=options, **KW)())
    masked = np.flip(piv.engine.window_masked[-1].numpy(), axis=0)
    assert masked.any() and not masked.all() and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g[2][masked] == 0).all()
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_decode_retries_mid_write_frame(tmp_path):
    fa, fb = particle_pair((64, 64), (1.0, 0.0), seed=7)
    pa, pb = str(tmp_path / "m0_a.bmp"), str(tmp_path / "m0_b.bmp")
    imwrite_gray(pa, fa)
    with open(pb, "wb") as f:  # listed, its bytes not complete yet
        f.write(b"\x00\x01not-a-bmp")
    piv = OnlinePIV(str(tmp_path), device="cpu", file_fmt=".bmp",
                    wind_size=32, overlap=16)

    def finish_write():
        time.sleep(0.06)  # between the first and the last attempt
        imwrite_gray(pb, fb)

    t = threading.Thread(target=finish_write)
    t.start()
    out = piv._decode(pa, pb)
    t.join(timeout=10)
    assert out is not None
    np.testing.assert_array_equal(out[0], fa)
    np.testing.assert_array_equal(out[1], fb)


def test_decode_skips_permanently_corrupt_frame(tmp_path, caplog):
    fa, _ = particle_pair((64, 64), (1.0, 0.0), seed=8)
    pa, pb = str(tmp_path / "c0_a.bmp"), str(tmp_path / "c0_b.bmp")
    imwrite_gray(pa, fa)
    with open(pb, "wb") as f:
        f.write(b"\x00\x01never-valid")
    piv = OnlinePIV(str(tmp_path), device="cpu", file_fmt=".bmp",
                    wind_size=32, overlap=16)
    with caplog.at_level(logging.WARNING, logger="torchpiv_tpu_torch"):
        assert piv._decode(pa, pb) is None
    assert any("skipping unreadable pair" in r.message for r in caplog.records)


@pytest.mark.parametrize("source", [StreamingPairSource, JaxStreamingPairSource],
                         ids=["port", "jax"])
def test_watcher_retains_early_b_file(tmp_path, source):
    src = source(str(tmp_path), ".bmp", poll_interval=0.01, idle_timeout=1.0)
    fa, fb = particle_pair((64, 64), (1.0, 0.0), seed=1)
    imwrite_gray(str(tmp_path / "p1_b.bmp"), fb)
    assert src.ready() == []  # _b alone: retained
    imwrite_gray(str(tmp_path / "p1_a.bmp"), fa)
    pairs = src.ready()
    assert [tuple(os.path.basename(p) for p in pr) for pr in pairs] == [
        ("p1_a.bmp", "p1_b.bmp")]


@pytest.mark.parametrize("source", [StreamingPairSource, JaxStreamingPairSource],
                         ids=["port", "jax"])
def test_watcher_ages_out_unmatched_orphans(tmp_path, source):
    src = source(str(tmp_path), ".bmp", poll_interval=0.01, orphan_timeout=0.2)
    (tmp_path / "x1_b.bmp").write_bytes(b"")
    (tmp_path / "x2_a.bmp").write_bytes(b"")
    assert src.ready() == []
    assert len(src._pending) == 2
    time.sleep(0.3)
    assert src.ready() == []
    assert src._pending == [] and src._first_seen == {}
    (tmp_path / "x1_a.bmp").write_bytes(b"")  # an aged-out frame never pairs
    assert src.ready() == []


# ---- DeviceMap and the device rule -----------------------------------------

def test_device_map_on_the_cpu():
    assert DeviceMap.resolve("cpu") == torch.device("cpu")
    assert DeviceMap.resolve(torch.device("cpu")) == torch.device("cpu")
    assert "cpu" in DeviceMap.devices()


@pytest.mark.parametrize("name", ["tpu", "tpu:0", "gpu", "cuda:x", "mps"])
def test_device_map_refuses_other_names(name):
    with pytest.raises(ValueError, match="the port takes"):
        DeviceMap.resolve(name)


@pytest.mark.parametrize("name", ["auto", "", None, "default", "cuda", "cuda:0"])
def test_device_map_without_a_card_names_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceMap.resolve(name)


def test_device_map_with_cards(monkeypatch):
    """Two (stand-in) cards: every CUDA name maps to its own device, and
    ``"tpu"`` still raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert set(DeviceMap.devices()) == {"cpu", "cuda", "cuda:0", "cuda:1"}
    assert DeviceMap.resolve("auto") == torch.device("cuda", 1)
    assert DeviceMap.resolve("cuda") == torch.device("cuda", 1)
    assert DeviceMap.resolve("cuda:0") == torch.device("cuda", 0)
    assert DeviceMap.resolve(str(torch.device("cuda", 1))) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="2 CUDA device"):
        DeviceMap.resolve("cuda:2")
    with pytest.raises(ValueError, match="the port takes"):
        DeviceMap.resolve("tpu")


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlinePIV(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoPIV(str(tmp_path / "none.avi"))
    from torchpiv_tpu_torch.serve import PIVService

    with pytest.raises(RuntimeError, match="device='cpu'"):
        PIVService()
    with pytest.raises(ValueError, match="the port takes"):
        OnlinePIV(str(tmp_path), device="tpu")


# ---- VideoPIV --------------------------------------------------------------

def _write_video(path, frames):
    cv2 = pytest.importorskip("cv2")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                         frames[0].shape[::-1], False)
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """Seven frames of particles moving 3 px a frame: three pairs and a
    lone frame, or six sequential pairs."""
    field, _ = particle_pair((128, 128 + 18), (0.0, 0.0), seed=60)
    frames = [np.ascontiguousarray(field[:, 3 * (6 - k):3 * (6 - k) + 128])
              for k in range(7)]
    path = str(tmp_path_factory.mktemp("video") / "run.avi")
    _write_video(path, frames)
    return path


@pytest.mark.parametrize("mode,n", [("pairs", 3), ("sequential", 6)])
def test_video_piv_matches_jax_video_piv(video, mode, n):
    kw = dict(wind_size=32, overlap=16, multipass=2, dt=2.0, scale=0.05,
              folder_mode=mode, batch_size=4)
    want = list(JaxVideoPIV(video, device="cpu", engine_options=JAX_OPTIONS, **kw)())
    piv = VideoPIV(video, device="cpu", **kw)
    got = list(piv())
    assert len(piv) == n and len(want) == n  # the last batch is short
    _close(got, want)


def test_chip_smoke_video_stand_in_reads_like_opencv(video, monkeypatch):
    """The stand-in that ``chip_smoke.py`` puts in place of OpenCV where the
    card's machine has none gives ``VideoPairSource`` the frames OpenCV
    decodes."""
    import cv2

    from torchpiv_tpu_torch.io import video as video_mod

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cap = cv2.VideoCapture(video)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) if f.ndim == 3 else f)
    cap.release()
    for mode in ("pairs", "sequential"):
        want = list(video_mod.VideoPairSource(video, mode))
        monkeypatch.setattr(video_mod, "cv2", smoke.video_stand_in({video: frames}))
        src = video_mod.VideoPairSource(video, mode, max_pairs=5)
        got = list(src)
        monkeypatch.undo()
        assert src.frame_shape == SHAPE and len(got) == min(5, len(want))
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_run_packed_enters_the_engines_device(monkeypatch):
    """A thread other than the main one launches on the engine's card:
    ``run_packed`` enters its device (here a stand-in context manager)."""
    entered = []

    class Device:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            return False

    class Engine:
        device = torch.device("cuda", 1)

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(pipeline, "packed_forward",
                        lambda eng, a, b: torch.zeros(len(a), 3, 2, 2))
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self)
    z = np.zeros((4, 4), np.uint8)
    out = pipeline.run_packed(Engine(), [z, z], [z, z])
    assert out.shape == (2, 3, 2, 2) and entered == [torch.device("cuda", 1)]
