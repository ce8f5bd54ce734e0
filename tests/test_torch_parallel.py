"""The port's mesh and ``ShardedPIV`` (``torchpiv_tpu_torch.parallel``) on
the CPU against the JAX ``ShardedPIV`` on conftest's 8-device CPU mesh (the
interpreted Pallas kernels: the semantics the TPU paths run; DEF + bicubic
against its XLA path, as ``tests/test_parallel.py`` runs that knob), the
pair and window splits against the port's own engine, ``OfflinePIV(mesh=)``
against the same call without a mesh and against the JAX
``OfflinePIV(mesh=)``, and ``parallel.meshprof``.  The port's meshes repeat the CPU device
(``[cpu] * 8``); its window split runs the plain versions of the kernels on
each shard's block of window rows.

Tolerances: against the JAX ``ShardedPIV``, the JAX suite's own (mask
agreement above 0.99, RMS below 0.01 px on jointly valid vectors): the two
engines group their reductions differently.  The pair split is bit-equal
to the unsharded port engine (the same engine on a slice of the batch; the
CPU ops give a pair the same bits in any batch).  The window split against
the unsharded port engine: within the same budget (a block's predictor rows
come from a row slice of the upsample matrix, a different matmul)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.io.decode import imwrite_gray
from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu.parallel import ShardedPIV as JaxShardedPIV
from torchpiv_tpu.parallel import make_mesh as jax_make_mesh
from torchpiv_tpu.parallel.meshprof import _dup_row_fraction as jax_dup_rows
from torchpiv_tpu.parallel.sharded import _block_layout as jax_block_layout
from torchpiv_tpu.pipeline import OfflinePIV as JaxOfflinePIV
from torchpiv_tpu.utils.synthetic import particle_pair
from torchpiv_tpu_torch import MultipassPIV, OfflinePIV, PIVConfig
from torchpiv_tpu_torch.parallel import (ShardedPIV, default_piv_mesh,
                                         make_mesh)
from torchpiv_tpu_torch.parallel import __all__ as port_all
from torchpiv_tpu_torch.parallel.meshprof import profile
from torchpiv_tpu_torch.parallel.sharded import _block_layout

CPU = torch.device("cpu")
SHAPE = (256, 256)
BASE = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2)


@pytest.fixture(scope="module")
def batch():
    pairs = [particle_pair(SHAPE, displacement=d, seed=s)
             for d, s in [((3.3, -2.1), 1), ((1.0, 0.5), 2),
                          ((-2.0, 1.5), 3), ((4.0, -1.0), 4)]]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


@pytest.fixture(scope="module")
def noisy_batch():
    """Pairs where the second-peak fallback rescues vectors."""
    pairs = [particle_pair(SHAPE, displacement=(6.0, -4.5), seed=s,
                           density=0.0035, noise=14.0) for s in (2, 5)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _wall():
    mask = np.zeros(SHAPE, bool)
    mask[96:160, :] = True
    return mask


def _port(cfg_kw, axes, fa, fb, frame_mask=None):
    eng = MultipassPIV(PIVConfig(**BASE, **cfg_kw), device="cpu", frame_mask=frame_mask)
    sharded = ShardedPIV(eng, make_mesh(axes, [CPU] * 8))
    u, v, inval = sharded(torch.from_numpy(fa), torch.from_numpy(fb))
    return eng, u.numpy(), v.numpy(), inval.numpy()


def _jax(cfg_kw, axes, fa, fb, frame_mask=None, pallas=True):
    """The JAX ``ShardedPIV``'s fields; ``pallas``: its interpreted Pallas
    kernels (``use_pallas="on", pallas_interpret=True``), else its XLA
    path, the default on the CPU."""
    kernels = dict(use_pallas="on", pallas_interpret=True) if pallas else {}
    eng = JaxMultipassPIV(JaxPIVConfig(**BASE, **cfg_kw, **kernels), frame_mask=frame_mask)
    out = jax.jit(JaxShardedPIV(eng, jax_make_mesh(axes)))(jnp.asarray(fa), jnp.asarray(fb))
    return tuple(np.asarray(t) for t in out)


def _assert_parity(got, want, on_agree=False):
    u, v, inval = got
    ru, rv, ri = want
    assert u.shape == ru.shape
    agree = inval == ri
    assert agree.mean() > 0.99
    both = agree if on_agree else ~(inval | ri) & agree
    assert both.mean() > 0.5
    for a, b in ((u, ru), (v, rv)):
        assert np.sqrt(np.mean((a[both] - b[both]) ** 2)) < 0.01


def test_exports_match_the_jax_package():
    from torchpiv_tpu.parallel import __all__ as jax_all

    assert sorted(port_all) == sorted(jax_all)


def test_mesh_shapes_and_refusals():
    mesh = make_mesh({"pairs": 2, "windows": 4}, [CPU] * 8)
    assert mesh.shape == {"pairs": 2, "windows": 4}
    assert mesh.axis_names == ("pairs", "windows")
    assert mesh.devices.shape == (2, 4) and set(mesh.device_list) == {CPU}
    assert make_mesh(None, [CPU] * 3).shape == {"pairs": 3}
    assert make_mesh({"pairs": 2}, ["cpu"] * 5).devices.size == 2  # the first two
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        make_mesh({"pairs": 2, "windows": 4}, [CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_piv_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh({"pairs": 1})


@pytest.mark.parametrize("R,n", [(1, 1), (7, 2), (15, 4), (15, 8), (63, 4),
                                 (127, 2), (127, 4), (3, 8)])
def test_block_layout_equals_jax(R, n):
    rloc, origins, pos = _block_layout(R, n)
    jrloc, jorigins, jpos = jax_block_layout(R, n)
    assert rloc == jrloc
    np.testing.assert_array_equal(origins, jorigins)
    np.testing.assert_array_equal(pos, jpos)


@pytest.mark.parametrize("axes", [{"pairs": 4}, {"pairs": 2, "windows": 4},
                                  {"pairs": 4, "windows": 2}, {"pairs": 1, "windows": 8}],
                         ids=lambda a: "-".join(f"{k}{v}" for k, v in a.items()))
def test_cws_matches_jax_sharded_piv(batch, axes):
    fa, fb = batch
    B = axes["pairs"] if "windows" in axes else 4
    _, *got = _port({"multipass_mode": "CWS"}, axes, fa[:B], fb[:B])
    _assert_parity(got, _jax({"multipass_mode": "CWS"}, axes, fa[:B], fb[:B]))


@pytest.mark.parametrize("mode", ["DWS", "DEF"])
def test_modes_match_jax_sharded_piv(batch, mode):
    fa, fb = batch
    axes = {"pairs": 2, "windows": 4}
    _, *got = _port({"multipass_mode": mode}, axes, fa[:2], fb[:2])
    _assert_parity(got, _jax({"multipass_mode": mode}, axes, fa[:2], fb[:2]))


KNOBS = {
    "weights-gauss2d": dict(window_weight="gaussian", subpixel="gauss2d"),
    "def-bicubic": dict(multipass_mode="DEF", cws_interp="bicubic"),
    "rpc": dict(correlation="rpc"),
    "median-fused-infill": dict(median_filter="normmedian", infill="fused"),
    "global-filters": dict(global_std=4.0, u_limits=(-10.0, 10.0)),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_knobs_match_jax_sharded_piv(batch, knob):
    fa, fb = batch
    axes = {"pairs": 2, "windows": 4}
    _, *got = _port(KNOBS[knob], axes, fa[:2], fb[:2])
    # DEF + bicubic against the JAX XLA path, as tests/test_parallel.py runs
    # its knobs: the interpreted bicubic DEF kernel unrolls all 15 columns
    # of the pass-2 grid and takes minutes to compile under the parallel
    # suite.  The window split runs the engine's own DEF pass on row blocks,
    # so the interpreted kernels' semantics are held in three steps: the
    # engine against them (test_torch_engine.py, DEF-bicubic), the row
    # blocks against them (test_torch_rowblocks.py, def-bicubic) and the
    # window split against the engine (test_window_split_matches_the_engine,
    # def-bicubic)
    want = _jax(KNOBS[knob], axes, fa[:2], fb[:2], pallas=knob != "def-bicubic")
    _assert_parity(got, want, on_agree=knob == "median-fused-infill")


def test_frame_mask_matches_jax_sharded_piv(batch):
    """The static ROI mask: pixels zeroed, each shard's masked window rows
    invalid with zero displacement; also with the median filter and no
    peak-ratio validation."""
    fa, fb = batch
    axes = {"pairs": 2, "windows": 4}
    eng, *got = _port({}, axes, fa[:2], fb[:2], frame_mask=_wall())
    wm = eng.window_masked[-1].numpy()
    assert wm.any() and got[2][:, wm].all() and (got[0][:, wm] == 0).all()
    _assert_parity(got, _jax({}, axes, fa[:2], fb[:2], frame_mask=_wall()))
    kw = dict(validate=False, median_filter="median")
    _, *got = _port(kw, {"pairs": 1, "windows": 4}, fa[:1], fb[:1], frame_mask=_wall())
    assert got[2][:, wm].all()


def test_second_peak_fallback_matches_jax_sharded_piv(noisy_batch):
    fa, fb = noisy_batch
    kw = dict(median_filter="normmedian", second_peak_fallback=True)
    axes = {"pairs": 2, "windows": 4}
    _, *got = _port(kw, axes, fa, fb)
    _assert_parity(got, _jax(kw, axes, fa, fb))
    # the fallback rescued vectors on this input
    eng = MultipassPIV(PIVConfig(**BASE, median_filter="normmedian"), device="cpu")
    _, _, without = eng(torch.from_numpy(fa), torch.from_numpy(fb))
    assert int(without.sum()) > int(got[2].sum())


@pytest.mark.parametrize("cfg_kw", [{}, {"multipass_mode": "DEF", "peakfit": "pallas"},
                                    {"fused": "split"}, {"fused": "on"},
                                    {"shift_variant": "bf16", "multipass_mode": "DWS"}],
                         ids=["cws", "def-pallas-fit", "split", "on", "dws-bf16"])
@pytest.mark.parametrize("axes", [{"pairs": 4}, {"pairs": 2}, {"pairs": 1}],
                         ids=["pairs4", "pairs2", "pairs1"])
def test_pair_split_is_bit_equal_to_the_engine(batch, cfg_kw, axes):
    fa, fb = (torch.from_numpy(f) for f in batch)
    eng = MultipassPIV(PIVConfig(**BASE, **cfg_kw), device="cpu")
    want = eng(fa, fb)
    sharded = ShardedPIV(eng, make_mesh(axes, [CPU] * 4))
    got = sharded(fa, fb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    packed = sharded.packed(fa, fb)
    assert packed.shape == (4, 3, *eng.final_field_shape)
    assert torch.equal(packed[:, 2] > 0.5, want[2])
    with pytest.raises(ValueError, match="does not divide"):
        ShardedPIV(eng, make_mesh({"pairs": 3}, [CPU] * 3))(fa, fb)


@pytest.mark.parametrize("cfg_kw", [{}, {"multipass_mode": "DWS"},
                                    {"multipass_mode": "DEF", "peakfit": "pallas"},
                                    {"cws_interp": "bicubic"},
                                    {"multipass_mode": "DEF", "cws_interp": "bicubic"},
                                    {"shift_variant": "phases"}, {"fused": "on"},
                                    {"multipass": 3}],
                         ids=["cws", "dws", "def-pallas-fit", "bicubic", "def-bicubic",
                              "phases", "fused-on-runs-unfused", "three-passes"])
def test_window_split_matches_the_engine(batch, cfg_kw):
    fa, fb = (torch.from_numpy(f[:2]) for f in batch)
    eng = MultipassPIV(PIVConfig(**{**BASE, **cfg_kw}), device="cpu")
    u0, v0, i0 = (t.numpy() for t in eng(fa, fb))
    for axes in ({"pairs": 1, "windows": 2}, {"pairs": 2, "windows": 3}):
        got = ShardedPIV(eng, make_mesh(axes, [CPU] * 6))(fa, fb)
        _assert_parity([t.numpy() for t in got], (u0, v0, i0))


def _folder(tmp_path, n=5):
    rng = np.random.default_rng(5)
    glare = rng.uniform(0, 60, SHAPE).astype(np.uint8)
    for i in range(n):
        fa, fb = particle_pair(SHAPE, displacement=(3.0 - 0.5 * i, 1.0), seed=80 + i)
        for tag, f in (("a", fa), ("b", fb)):
            imwrite_gray(str(tmp_path / f"m{i}_{tag}.bmp"),
                         np.clip(f.astype(int) + glare, 0, 255).astype(np.uint8))
    return str(tmp_path)


@pytest.mark.parametrize("background", ["none", "auto"])
def test_offline_piv_over_a_mesh(tmp_path, background):
    """5 pairs: a short last batch, padded by repeating its last pair and
    its padded fields dropped."""
    folder = _folder(tmp_path)
    kw = dict(device="cpu", file_fmt=".bmp", wind_size=64, overlap=32,
              multipass=2, background=background)
    plain = list(OfflinePIV(folder, batch_size=4, **kw)())
    assert len(plain) == 5
    for axes in ({"pairs": 2}, {"pairs": 1}, {"pairs": 2, "windows": 2}):
        piv = OfflinePIV(folder, batch_size=3, mesh=make_mesh(axes, [CPU] * 4), **kw)
        assert piv._batch == (4 if axes["pairs"] == 2 else 3)
        piv.span_log = []
        got = list(piv())
        assert len(got) == 5 and len(piv.span_log) == 2
        assert sum(s["pairs"] for s in piv.span_log) == 5
        for (x0, y0, u0, v0), (x1, y1, u1, v1) in zip(plain, got):
            np.testing.assert_array_equal(x0, x1)
            np.testing.assert_array_equal(y0, y1)
            if "windows" not in axes:
                np.testing.assert_array_equal(u0, u1)
                np.testing.assert_array_equal(v0, v1)
            else:
                for a, b in ((u0, u1), (v0, v1)):
                    d = np.abs(a - b) / 1000.0  # output units -> px
                    assert np.sqrt(np.mean(d ** 2)) < 0.01


def test_offline_piv_over_a_mesh_matches_jax(tmp_path):
    folder = _folder(tmp_path)
    kw = dict(device="cpu", file_fmt=".bmp", wind_size=64, overlap=32,
              multipass=2, background="auto", batch_size=4)
    want = list(JaxOfflinePIV(folder, mesh=jax_make_mesh({"pairs": 2, "windows": 2}),
                              engine_options={"pallas_interpret": True}, **kw)())
    got = list(OfflinePIV(folder, mesh=make_mesh({"pairs": 2, "windows": 2}, [CPU] * 4),
                          **kw)())
    assert len(got) == len(want) == 5
    for (ox, oy, ou, ov), (rx, ry, ru, rv) in zip(got, want):
        np.testing.assert_array_equal(ox, rx)
        np.testing.assert_array_equal(oy, ry)
        for a, b in ((ou, ru), (ov, rv)):
            d = np.abs(np.asarray(a) - np.asarray(b)) / 1000.0
            assert np.isfinite(a).all()
            assert np.sqrt(np.mean(d ** 2)) < 0.01
            assert (d > 0.01).mean() < 0.02


def test_meshprof_table_on_the_cpu():
    lines = []
    rows = profile(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2,
                   splits=[1, 2, 4], reps=1, log=lines.append, devices=[CPU] * 4)
    assert [r["nw"] for r in rows] == [1, 2, 4]
    assert len(lines) == 2 + 3 and lines[0].startswith("| windows-split")
    assert rows[0]["vs_1way"] == 1.0 and rows[0]["gather_ms"] == 0.0
    field_rows = (7, 15)  # pass 1 and pass 2 window rows at 256 px
    for r in rows:
        assert r["ms"] > 0.0 and r["gather_bytes"] == 4 * 3 * (7 * 7 + 15 * 15)
        assert r["dup_rows_pct"] == max(jax_dup_rows(R, r["nw"]) for R in field_rows) * 100
        assert (r["gather_ms"] > 0.0) == (r["nw"] > 1)
