"""The port's three-stage ``OfflinePIV`` on the CPU: ``background`` and
``preprocess`` against the JAX ``OfflinePIV`` (running the interpreted
Pallas kernels) on the same BMP folder, the numpy copies against their
originals, the threaded loop against a serial one, early close, errors,
unreadable pairs, the transfer and span logs, the ramp-up batch, and the
shift-kernel anatomy tool's source edits.

Tolerance of the JAX comparisons, as in ``test_torch_pipeline.py``: ``x``
and ``y`` equal, ``u, v`` within RMS 0.01 px and fewer than 2% of the
components more than 0.01 px apart."""
import importlib.util
import pathlib
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from torchpiv_tpu.io.dataset import compute_background as jax_compute_background
from torchpiv_tpu.io.preprocess import clahe as jax_clahe
from torchpiv_tpu.io.preprocess import percentile_stretch as jax_percentile_stretch
from torchpiv_tpu.pipeline import OfflinePIV as JaxOfflinePIV
from torchpiv_tpu_torch import OfflinePIV
from torchpiv_tpu_torch.io.dataset import PIVDataset, compute_background
from torchpiv_tpu_torch.io.decode import imwrite_gray
from torchpiv_tpu_torch.io.prefetch import PairPrefetcher
from torchpiv_tpu_torch.io.preprocess import (PreprocessedPairs, clahe,
                                              percentile_stretch,
                                              resolve_preprocess)
from torchpiv_tpu_torch.kernels import _build
from torchpiv_tpu_torch.pipeline import finalize_fields, packed_forward
from torchpiv_tpu_torch.utils.synthetic import particle_pair

REPO = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (256, 256)
UNIT = 0.05 / 2.0 * 1000  # px -> output units at scale 0.05, dt 2
SPAN_KEYS = {"pairs", "decode_s", "pin_s", "h2d_ms", "load_s", "issue_s",
             "device_ms", "d2h_ms", "wait_s", "tail_s", "first_field_t", "call"}


def glare() -> np.ndarray:
    """A stationary bright band and a ramp: what a background removes."""
    g = np.zeros(SHAPE, np.int32)
    g[96:128, :] = 90
    g += np.arange(SHAPE[1])[None, :] // 8
    return g


def _write_pairs(folder, n, seed=20, with_glare=False):
    for i in range(n):
        fa, fb = particle_pair(SHAPE, (3.3, -2.1), seed=seed + i)
        if with_glare:
            fa = np.clip(fa + glare(), 0, 255).astype(np.uint8)
            fb = np.clip(fb + glare(), 0, 255).astype(np.uint8)
        imwrite_gray(str(folder / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(folder / f"p{i}_b.bmp"), fb)


def _as_float(frame):
    """A preprocess callable that returns float32, not uint8."""
    return frame.astype(np.float32) * 0.5 + 3.0


KW = dict(file_fmt=".bmp", wind_size=64, overlap=32, multipass=2,
          multipass_mode="CWS", dt=2.0, scale=0.05, folder_mode="pairs")


@pytest.mark.parametrize("knobs", [
    dict(background="auto"),
    dict(background="array"),
    dict(preprocess="clahe"),
    dict(preprocess="stretch"),
    dict(preprocess=_as_float),
], ids=["background-auto", "background-array", "clahe", "stretch", "float-callable"])
def test_background_and_preprocess_match_jax_offline_piv(tmp_path, knobs):
    _write_pairs(tmp_path, 3, with_glare=True)
    if knobs.get("background") == "array":
        knobs = dict(background=np.clip(glare(), 0, 255).astype(np.uint8))
    want = list(JaxOfflinePIV(str(tmp_path), device="cpu",
                              engine_options={"pallas_interpret": True},
                              **knobs, **KW)())
    got = list(OfflinePIV(str(tmp_path), device="cpu", batch_size=2, **knobs, **KW)())
    assert len(got) == len(want) == 3
    for (ox, oy, ou, ov), (rx, ry, ru, rv) in zip(got, want):
        np.testing.assert_array_equal(ox, rx)
        np.testing.assert_array_equal(oy, ry)
        for a, b in ((ou, ru), (ov, rv)):
            d = np.abs(np.asarray(a) - np.asarray(b)) / UNIT
            assert np.isfinite(a).all()
            assert np.sqrt(np.mean(d ** 2)) < 0.01
            assert (d > 0.01).mean() < 0.02
        assert abs(np.median(ou) / UNIT - 3.3) < 0.1


def test_background_is_subtracted_with_saturation(tmp_path):
    """``background="auto"`` gives the fields of the same engine run on
    frames whose background was subtracted on the host, bit for bit."""
    (tmp_path / "raw").mkdir()
    _write_pairs(tmp_path / "raw", 3, with_glare=True)
    raw = PIVDataset(str(tmp_path / "raw"), ".bmp")
    bg = compute_background(raw)
    (tmp_path / "clean").mkdir()
    for i in range(len(raw)):
        fa, fb = raw[i]
        for f, tag in ((fa, "a"), (fb, "b")):
            clean = np.where(f > bg, f - bg, 0).astype(np.uint8)
            imwrite_gray(str(tmp_path / "clean" / f"p{i}_{tag}.bmp"), clean)
    got = list(OfflinePIV(str(tmp_path / "raw"), device="cpu", batch_size=2,
                          background="auto", **KW)())
    want = list(OfflinePIV(str(tmp_path / "clean"), device="cpu", batch_size=2, **KW)())
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw,match", [
    (dict(background="median"), "background"),
    (dict(preprocess="sharpen"), "preprocess"),
])
def test_unknown_background_or_preprocess_raises(tmp_path, kw, match):
    _write_pairs(tmp_path, 1)
    with pytest.raises(ValueError, match=match):
        OfflinePIV(str(tmp_path), device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        JaxOfflinePIV(str(tmp_path), device="cpu", **kw)


def test_numpy_copies_equal_the_jax_package_originals(tmp_path):
    _write_pairs(tmp_path, 4, with_glare=True)
    ds = PIVDataset(str(tmp_path), ".bmp")
    for n_pairs in (1, 3, 20):
        np.testing.assert_array_equal(compute_background(ds, n_pairs),
                                      jax_compute_background(ds, n_pairs))
    rng = np.random.default_rng(7)
    frames = [ds[0][0], rng.integers(0, 256, (100, 130), dtype=np.uint8),
              np.full((64, 64), 17, np.uint8)]
    for f in frames:
        for tiles, clip in ((8, 2.0), (3, 1.0)):
            np.testing.assert_array_equal(clahe(f, tiles, clip), jax_clahe(f, tiles, clip))
        for lo, hi in ((1.0, 99.0), (5.0, 60.0)):
            np.testing.assert_array_equal(percentile_stretch(f, lo, hi),
                                          jax_percentile_stretch(f, lo, hi))
    assert resolve_preprocess("none") is None and resolve_preprocess(None) is None
    assert resolve_preprocess("clahe") is clahe
    assert resolve_preprocess(_as_float) is _as_float
    with pytest.raises(ValueError, match="clahe"):
        clahe(frames[0].astype(np.float32))


def serial_fields(piv):
    """The loop the pipeline replaced: prefetch, engine, host copy, tail,
    one batch after the other on the calling thread."""
    engine = piv.engine
    x, y = engine.final_coordinates
    out = []
    for a, b, ids in PairPrefetcher(piv._dataset, piv._batch, torch.device("cpu")):
        packed = packed_forward(engine, a, b).numpy()
        for i in range(len(ids)):
            res = finalize_fields(packed[i, 0], packed[i, 1], packed[i, 2] > 0.5,
                                  x, y, piv._scale, piv._dt)
            if res is not None:
                out.append(res)
    return out


@pytest.mark.parametrize("batch,threads,switch", [(2, 4, None), (1, 8, 1e-6)],
                         ids=["batch2", "batch1-eight-threads-fast-switching"])
def test_threaded_loop_yields_the_serial_loops_fields_in_order(tmp_path, batch,
                                                               threads, switch):
    """Same fields, same order; the second case runs more threads than
    cores with the interpreter switching threads as often as it can."""
    for i in range(5):  # distinct displacements tell the pairs apart
        fa, fb = particle_pair(SHAPE, (1.0 + 0.5 * i, -2.1), seed=40 + i)
        imwrite_gray(str(tmp_path / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(tmp_path / f"p{i}_b.bmp"), fb)
    piv = OfflinePIV(str(tmp_path), device="cpu", batch_size=batch,
                     decode_threads=threads, **KW)
    want = serial_fields(piv)
    old = sys.getswitchinterval()
    if switch:
        sys.setswitchinterval(switch)
    try:
        got = list(piv())
    finally:
        sys.setswitchinterval(old)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)
    medians = [np.median(u) / UNIT for _, _, u, _ in got]
    assert np.allclose(medians, [1.0 + 0.5 * i for i in range(5)], atol=0.1)


def _pipeline_threads():
    return [t for t in threading.enumerate() if t.name.startswith("piv-")]


def _joined(deadline_s=30.0):
    deadline = time.time() + deadline_s
    while _pipeline_threads() and time.time() < deadline:
        time.sleep(0.05)
    return not _pipeline_threads()


def test_early_close_joins_the_threads(tmp_path):
    _write_pairs(tmp_path, 6)
    piv = OfflinePIV(str(tmp_path), device="cpu", batch_size=1, **KW)
    gen = piv()
    next(gen)
    assert {t.name for t in _pipeline_threads()} == {"piv-feeder", "piv-drainer"}
    gen.close()
    assert _joined(), f"pipeline threads leaked: {_pipeline_threads()}"


@pytest.mark.parametrize("where", ["engine", "decode"])
def test_an_error_of_either_stage_reaches_the_caller(tmp_path, where):
    _write_pairs(tmp_path, 3)
    piv = OfflinePIV(str(tmp_path), device="cpu", batch_size=1, **KW)

    def boom(*args, **kwargs):
        raise RuntimeError(f"synthetic {where} failure")

    if where == "engine":
        piv.engine.forward = boom
    else:
        piv._dataset.read_batch = boom
    with pytest.raises(RuntimeError, match=f"synthetic {where} failure"):
        list(piv())
    assert _joined(), f"pipeline threads leaked: {_pipeline_threads()}"


def test_unreadable_pairs_are_dropped(tmp_path):
    _write_pairs(tmp_path, 5)
    (tmp_path / "p1_a.bmp").write_bytes(b"")
    (tmp_path / "p3_b.bmp").write_bytes(b"BM" + bytes(10))
    for knobs in ({}, {"preprocess": "stretch"}):  # read_batch, or pair by pair
        piv = OfflinePIV(str(tmp_path), device="cpu", batch_size=2, **knobs, **KW)
        piv.span_log = []
        got = list(piv())
        assert len(got) == 3
        assert sum(s["pairs"] for s in piv.span_log) == 3


def test_transfer_log_counts_the_frames_bytes(tmp_path):
    _write_pairs(tmp_path, 3)
    piv = OfflinePIV(str(tmp_path), device="cpu", batch_size=2, **KW)
    piv.transfer_log = tlog = []
    assert len(list(piv())) == 3
    assert len(tlog) == 2  # 3 pairs at batch 2: batches of 2 and 1
    assert all(t1 >= t0 for t0, t1, _ in tlog)
    assert sum(nb for _, _, nb in tlog) == 3 * 2 * SHAPE[0] * SHAPE[1]


def test_prefetcher_ramps_up_with_a_small_first_batch(tmp_path):
    _write_pairs(tmp_path, 3)
    ds = PIVDataset(str(tmp_path), ".bmp")
    cpu = torch.device("cpu")
    sizes = [len(ids) for _, _, ids in PairPrefetcher(ds, 2, cpu, first_batch_size=1)]
    assert sizes == [1, 2]
    assert [len(ids) for _, _, ids in PairPrefetcher(ds, 2, cpu)] == [2, 1]
    # a dataset without read_batch (preprocessed) goes pair by pair
    pp = PreprocessedPairs(ds, percentile_stretch)
    seen = []
    for a, b, ids, span in PairPrefetcher(pp, 2, cpu, first_batch_size=1,
                                          spans=True).batches():
        for k, i in enumerate(ids):
            fa, fb = pp[i]
            assert np.array_equal(a[k].numpy(), fa) and np.array_equal(b[k].numpy(), fb)
        assert span["decode_s"] > 0 and span["pin_s"] == 0 and span["h2d"] is None
        seen.append(ids)
    assert seen == [[0], [1, 2]]
    # the engine's ramp-up: at most 4 pairs first
    assert OfflinePIV(str(tmp_path), device="cpu", batch_size=2)._first_batch == 2
    assert OfflinePIV(str(tmp_path), device="cpu", batch_size=8)._first_batch == 4


def test_span_log_has_one_entry_per_batch_with_every_key(tmp_path):
    _write_pairs(tmp_path, 5)
    piv = OfflinePIV(str(tmp_path), device="cpu", batch_size=4, **KW)
    assert piv.span_log is None and piv.transfer_log is None
    plain = list(piv())
    piv.span_log = spans = []
    t0 = time.perf_counter()
    timed = list(piv())
    assert len(timed) == len(plain) == 5
    for a, b in zip(timed, plain):  # the spans change no result
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q)
    assert [s["pairs"] for s in spans] == [4, 1]
    for s in spans:
        assert set(s) == SPAN_KEYS
        for key in ("decode_s", "pin_s", "load_s", "issue_s", "wait_s", "tail_s"):
            assert s[key] >= 0.0
        for key in ("h2d_ms", "device_ms", "d2h_ms"):  # CUDA events only
            assert s[key] is None
        assert s["call"] is None  # records are kept under the profiler only
        assert s["first_field_t"] > t0
    assert spans[0]["first_field_t"] < spans[1]["first_field_t"]


def _anatomy_tool():
    spec = importlib.util.spec_from_file_location(
        "shift_anatomy_cuda", REPO / "tools" / "shift_anatomy_cuda.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_anatomy_tool_edits_the_committed_sources():
    """Every edit of every mode matches the committed kernel sources once
    (a change to them that breaks the tool fails here), ``full`` is the
    committed text, and the build is pointed back at the package's
    sources afterwards."""
    tool = _anatomy_tool()
    csrc, flags = _build.CSRC, _build.NVCC_FLAGS
    assert tool.SOURCES == csrc
    committed = {name: (csrc / name).read_text() for name in ("shift_windows.cu", "shift.cuh")}
    assert tool.edited_sources("full") == committed
    assert set(tool.EDITS) == {"full", "noshuffle", "rowbyrow", "noblend", "loadonly",
                               "storeonly"}
    for mode in tool.EDITS:
        edited = tool.edited_sources(mode)
        changed = {name for name in committed if edited[name] != committed[name]}
        assert changed == set(tool.EDITS[mode]), mode
        copy = tool.edited_copy(mode)
        try:
            with tool.pointed_at(copy):
                assert _build.CSRC == copy and _build.NVCC_FLAGS == flags + tool.PTXAS
                assert _build.sources() == sorted(p.stem for p in csrc.glob("*.cu"))
                for name, text in edited.items():
                    assert (copy / name).read_text() == text
        finally:
            shutil.rmtree(copy)
        assert _build.CSRC == csrc and _build.NVCC_FLAGS == flags
    assert "__shfl_sync" not in tool.edited_sources("noshuffle")["shift_windows.cu"]
    assert "rows_ahead() { return 1; }" in tool.edited_sources("rowbyrow")["shift_windows.cu"]
    assert "__ldg(p + G * k)" not in tool.edited_sources("storeonly")["shift_windows.cu"]
    with pytest.raises(KeyError):
        tool.edited_sources("norolls")  # a TPU mode with no counterpart
    assert tool.ptxas_summary(
        "ptxas info    : Used 30 registers, 8 bytes smem, 380 bytes cmem[0]\n"
        "ptxas info    : 0 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads") \
        == {"registers": 30, "static_shared_bytes": 8, "spill_stores": 4, "spill_loads": 12}
    assert tool.ptxas_summary("ptxas info    : Used 32 registers, 380 bytes cmem[0]")[
        "static_shared_bytes"] == 0
