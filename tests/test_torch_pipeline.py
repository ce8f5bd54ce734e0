"""The port's pipeline layer: OfflinePIV end to end against the JAX
OfflinePIV (running the interpreted Pallas kernels) on the same BMP folder,
also with a region-of-interest mask, a shift variant and the robust knobs,
the host tail, the I/O copies, the prefetcher, the device rules, and a
source scan that keeps JAX and the JAX package out of the port and its
CUDA tools.  The pipeline's threads, background and preprocess are in
``test_torch_threads.py``."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from torchpiv_tpu.io.dataset import list_pairs as jax_list_pairs
from torchpiv_tpu.io.decode import imread_gray as jax_imread_gray
from torchpiv_tpu.pipeline import OfflinePIV as JaxOfflinePIV
from torchpiv_tpu.pipeline import finalize_fields as jax_finalize_fields
from torchpiv_tpu_torch import OfflinePIV
from torchpiv_tpu_torch.io.dataset import PIVDataset, list_pairs
from torchpiv_tpu_torch.io.decode import imread_gray, imwrite_gray
from torchpiv_tpu_torch.io.prefetch import PairPrefetcher
from torchpiv_tpu_torch.pipeline import finalize_fields, resolve_frame_mask
from torchpiv_tpu_torch.utils.synthetic import particle_pair

REPO = pathlib.Path(__file__).resolve().parents[1]


def _write_pairs(folder, n, holes=True):
    for i in range(n):
        fa, fb = particle_pair((256, 256), (3.3, -2.1), seed=20 + i)
        if holes:  # a particle-free corner: invalid vectors, so infill runs
            fa[:72, :72] = 8
            fb[:72, :72] = 8
        imwrite_gray(str(folder / f"p{i}_a.bmp"), fa)
        imwrite_gray(str(folder / f"p{i}_b.bmp"), fb)


@pytest.mark.parametrize("mode,options,holes", [
    ("CWS", {}, True),
    ("DEF", {}, True),
    # The fused peak fit without the particle-free corner: in a blank window
    # the correlation is rounding noise around zero, where the TPU kernel's
    # (x - min) + EPS and the XLA fit's x + (EPS - min), which the port's CPU
    # path follows, validate differently (in the JAX package too).
    ("DEF", {"peakfit": "pallas", "cws_interp": "bicubic"}, False),
    # the pass-fusion kernels fit in the same order: no corner either
    ("CWS", {"fused": "split"}, False),
    ("CWS", {"fused": "on"}, False),
])
def test_offline_piv_matches_jax_offline_piv(tmp_path, mode, options, holes):
    _write_pairs(tmp_path, 3, holes=holes)
    kw = dict(file_fmt=".bmp", wind_size=64, overlap=32, multipass=2,
              multipass_mode=mode, dt=2.0, scale=0.05, folder_mode="pairs")
    want = list(JaxOfflinePIV(
        str(tmp_path), device="cpu",
        engine_options={"pallas_interpret": True, **options}, **kw)())
    got = list(OfflinePIV(str(tmp_path), device="cpu", batch_size=2,
                          engine_options=options, **kw)())
    assert len(got) == len(want) == 3
    unit = 0.05 / 2.0 * 1000  # px -> output units
    for (ox, oy, ou, ov), (rx, ry, ru, rv) in zip(got, want):
        np.testing.assert_array_equal(ox, rx)
        np.testing.assert_array_equal(oy, ry)
        for a, b in ((ou, ru), (ov, rv)):
            d = np.abs(np.asarray(a) - np.asarray(b)) / unit
            assert np.isfinite(a).all()
            assert np.sqrt(np.mean(d ** 2)) < 0.01
            assert (d > 0.01).mean() < 0.02


def _mask(kind):
    mask = np.zeros((256, 256), bool)
    if kind == "wall":
        mask[:, :48] = True
    else:  # most of the frame: more than half of the windows
        mask[:, :170] = True
    return mask


@pytest.mark.parametrize("options,kind,threshold", [
    ({}, "wall", 0.5),
    ({}, "most", 0.5),  # a large mask is no reason to skip the pair
    ({"mode": "DWS", "shift_variant": "bf16"}, "wall", 0.25),
    ({"shift_variant": "phases", "median_filter": "normmedian",
      "u_limits": (-8.0, 8.0), "v_limits": (-8.0, 8.0), "global_std": 5.0,
      "second_peak_fallback": True}, "wall", 0.5),
    ({"infill": "fused"}, "wall", 0.5),
    ({"infill": "none", "window_weight": "gaussian", "correlation": "rpc"}, "wall", 0.5),
], ids=["wall", "most", "dws-bf16", "robust", "fused-infill", "rpc-no-infill"])
def test_offline_piv_with_frame_mask_matches_jax_offline_piv(tmp_path, options, kind,
                                                            threshold):
    _write_pairs(tmp_path, 3, holes=True)
    mask = _mask(kind)
    options = dict(options)
    kw = dict(file_fmt=".bmp", wind_size=64, overlap=32, multipass=2,
              multipass_mode=options.pop("mode", "CWS"), dt=2.0, scale=0.05,
              folder_mode="pairs")
    roi = {"frame_mask": mask, "mask_threshold": threshold}
    want = list(JaxOfflinePIV(
        str(tmp_path), device="cpu",
        engine_options={"pallas_interpret": True, **options, **roi}, **kw)())
    piv = OfflinePIV(str(tmp_path), device="cpu", batch_size=2,
                     engine_options={**options, **roi}, **kw)
    got = list(piv())
    assert len(got) == len(want) == 3
    masked = np.flip(piv.engine.window_masked[-1].numpy(), axis=0)  # output rows
    assert masked.any() and not masked.all()
    unit = 0.05 / 2.0 * 1000
    for (ox, oy, ou, ov), (rx, ry, ru, rv) in zip(got, want):
        np.testing.assert_array_equal(ox, rx)
        np.testing.assert_array_equal(oy, ry)
        if options.get("infill", "host") != "fused":  # the device fill covers them
            assert (ou[masked] == 0).all() and (ov[masked] == 0).all()
        for a, b in ((ou, ru), (ov, rv)):
            d = np.abs(np.asarray(a) - np.asarray(b)) / unit
            assert np.isfinite(a).all()
            assert np.sqrt(np.mean(d ** 2)) < 0.01
            assert (d > 0.01).mean() < 0.02


def test_offline_piv_takes_the_mask_from_an_image(tmp_path):
    _write_pairs(tmp_path, 1, holes=False)
    mask = _mask("wall")
    path = str(tmp_path.parent / "roi_mask.bmp")
    imwrite_gray(path, mask.astype(np.uint8) * 255)
    np.testing.assert_array_equal(resolve_frame_mask(path), mask)
    np.testing.assert_array_equal(resolve_frame_mask(mask.astype(np.uint8)), mask)
    assert resolve_frame_mask(None) is None
    with pytest.raises(ValueError, match="mask"):
        resolve_frame_mask(str(tmp_path / "missing.bmp"))
    kw = dict(device="cpu", wind_size=64, overlap=32, multipass=2)
    from_file = OfflinePIV(str(tmp_path), engine_options={"frame_mask": path}, **kw)
    from_array = OfflinePIV(str(tmp_path), engine_options={"frame_mask": mask}, **kw)
    assert torch.equal(from_file.engine.frame_mask, from_array.engine.frame_mask)
    (a,), (b,) = list(from_file()), list(from_array())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_finalize_fields_with_static_mask_matches_jax():
    rng = np.random.default_rng(1)
    u = rng.normal(3.0, 0.1, (15, 15)).astype(np.float32)
    v = rng.normal(-2.0, 0.1, (15, 15)).astype(np.float32)
    inval = rng.uniform(size=(15, 15)) < 0.05
    x, y = np.meshgrid(np.arange(15.0) * 16 + 32, np.arange(15.0) * 16 + 32)
    static = np.zeros((15, 15), bool)
    static[:, :9] = True  # more than half the field
    for mask in (inval | static, None, np.ones((15, 15), bool)):
        got = finalize_fields(u, v, mask, x, y, 0.05, 2.0, static)
        want = jax_finalize_fields(u, v, mask, x, y, 0.05, 2.0, static)
        if want is None:
            assert got is None
            continue
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert (np.flip(got[2], 0)[static] == 0).all()
    # without the static mask the same windows are infilled, not zeroed
    plain = finalize_fields(u, v, inval | static, x, y, 0.05, 2.0)
    assert plain is None or (np.flip(plain[2], 0)[static] != 0).all()


@pytest.mark.parametrize("fused,mode", [("split", "CWS"), ("split", "DEF"),
                                        ("on", "CWS"), ("on", "DWS")])
def test_offline_piv_fused_modes_match_the_unfused_port(tmp_path, fused, mode):
    _write_pairs(tmp_path, 3, holes=False)
    kw = dict(device="cpu", batch_size=2, wind_size=64, overlap=32, multipass=2,
              multipass_mode=mode)
    piv = OfflinePIV(str(tmp_path), engine_options={"fused": fused}, **kw)
    assert piv.engine.config.fused == fused
    assert piv.engine._use_split() == (fused == "split")
    assert piv.engine._use_fused() == (fused == "on")
    got = list(piv())
    want = list(OfflinePIV(str(tmp_path), **kw)())
    assert len(got) == len(want) == 3
    for (_, _, ou, ov), (_, _, ru, rv) in zip(got, want):
        for a, b in ((ou, ru), (ov, rv)):
            d = np.abs(a - b) / 1000  # px
            assert np.isfinite(a).all()
            assert np.sqrt(np.mean(d ** 2)) < 0.01
            assert (d > 0.01).mean() < 0.02


def test_finalize_fields_matches_jax():
    rng = np.random.default_rng(0)
    u = rng.normal(3.0, 0.1, (15, 15)).astype(np.float32)
    v = rng.normal(-2.0, 0.1, (15, 15)).astype(np.float32)
    inval = rng.uniform(size=(15, 15)) < 0.05
    x, y = np.meshgrid(np.arange(15.0) * 16 + 32, np.arange(15.0) * 16 + 32)
    for mask in (inval, None, np.ones((15, 15), bool)):
        got = finalize_fields(u, v, mask, x, y, 0.05, 2.0)
        want = jax_finalize_fields(u, v, mask, x, y, 0.05, 2.0)
        if want is None:
            assert got is None
            continue
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_bmp_round_trip_and_jax_decoder(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (37, 61), dtype=np.uint8)
    path = str(tmp_path / "f.bmp")
    imwrite_gray(path, img)
    np.testing.assert_array_equal(imread_gray(path), img)
    np.testing.assert_array_equal(jax_imread_gray(path), img)
    (tmp_path / "bad.bmp").write_bytes(b"BM" + bytes(10))
    assert imread_gray(str(tmp_path / "bad.bmp")) is None


@pytest.mark.parametrize("mode", ["pairs", "sequential"])
def test_list_pairs_matches_jax(tmp_path, mode):
    for name in ("img10.bmp", "img2.bmp", "img1.bmp", "img3.bmp", "x.txt"):
        (tmp_path / name).write_bytes(b"")
    assert list_pairs(str(tmp_path), ".bmp", mode) == \
        jax_list_pairs(str(tmp_path), ".bmp", mode)


def test_prefetcher_batches_in_order_and_skips_unreadable(tmp_path):
    _write_pairs(tmp_path, 5, holes=False)
    (tmp_path / "p2_b.bmp").write_bytes(b"")  # unreadable
    ds = PIVDataset(str(tmp_path), ".bmp")
    seen = []
    for a, b, ids in PairPrefetcher(ds, 2, torch.device("cpu"), num_threads=2):
        assert a.shape == b.shape == (len(ids), 256, 256) and a.dtype == torch.uint8
        for k, i in enumerate(ids):
            fa, fb = ds[i]
            assert np.array_equal(a[k].numpy(), fa) and np.array_equal(b[k].numpy(), fb)
        seen += ids
    assert seen == [0, 1, 3, 4]


def test_offline_piv_skip_and_max_pairs(tmp_path):
    _write_pairs(tmp_path, 3, holes=False)
    piv = OfflinePIV(str(tmp_path), device="cpu", skip_pairs=1, max_pairs=1)
    assert len(piv) == 1
    (out,) = list(piv())
    x, y, u, v = out
    assert u.shape == piv.engine.final_field_shape
    assert abs(np.median(u) / 1000 - 3.3) < 0.1 and abs(-np.median(v) / 1000 + 2.1) < 0.1


@pytest.mark.parametrize("kw", [
    # low-precision windows into the FFT: the JAX package's FFT refuses them
    dict(engine_options={"dtype": "bfloat16", "correlator": "fft"}),
    # the port computes in float types only
    dict(engine_options={"dtype": "int32"}),
])
def test_offline_piv_rejects_what_is_not_ported(tmp_path, kw):
    _write_pairs(tmp_path, 1, holes=False)
    with pytest.raises(ValueError):
        OfflinePIV(str(tmp_path), device="cpu", multipass=2, **kw)


def test_offline_piv_runs_bicubic_with_a_shift_variant_like_jax(tmp_path):
    """Both pipelines send bicubic CWS with a shift variant to the XLA
    bicubic shift: the port's fields within the parity budget of the JAX
    ``OfflinePIV``'s (which pins ``use_pallas="off"`` on the CPU)."""
    _write_pairs(tmp_path, 2, holes=False)
    kw = dict(device="cpu", multipass=2,
              engine_options={"cws_interp": "bicubic", "shift_variant": "mxu"})
    got = list(OfflinePIV(str(tmp_path), **kw)())
    want = list(JaxOfflinePIV(str(tmp_path), **kw)())
    assert len(got) == len(want) == 2
    for (x, y, u, v), (jx, jy, ju, jv) in zip(got, want):
        np.testing.assert_array_equal(x, jx)
        d = np.concatenate([(u - ju).ravel(), (v - jv).ravel()]) / 1000.0
        assert np.mean(np.abs(d) > 0.01) < 0.02 and np.sqrt(np.mean(d ** 2)) < 0.01


def test_offline_piv_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _write_pairs(tmp_path, 1, holes=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OfflinePIV(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OfflinePIV(str(tmp_path), device="auto")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_port_never_imports_jax_or_the_jax_package():
    tools = sorted((REPO / "tools").glob("*_cuda.py"))
    assert len(tools) >= 2
    files = (sorted((REPO / "torchpiv_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + tools)
    assert len(files) > 15
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "torchpiv_tpu"), f"{path}: {mod}"
