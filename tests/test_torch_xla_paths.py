"""The JAX engine's XLA resampling paths in the port (``use_pallas="off"``,
refine windows beyond the kernels' limits, bicubic CWS with a shift
variant) against the JAX package on the same numpy inputs from a seed:

* ``ops.shifts.cws_shift``/``bicubic_cws_shift``/``dws_shift`` with
  per-window and per-pixel shifts, shifts beyond ``w/2`` and windows that
  leave the frame (the flat-index wrap), in float32 within 1e-4 of a grey
  level (XLA's CPU backend may contract a multiply-add), and in bfloat16
  and float16 within one unit in the last place at 256 (2 and 0.25 grey
  levels);
* ``ops.deform.def_windows_xla`` against the JAX engine's dense shifts fed
  to its ``cws_shift``/``bicubic_cws_shift``, in the same tolerance;
* ``ops.windows.window_index_1d``/``flat_window_grid``, exactly equal;
* ``MultipassPIV(use_pallas="off")`` against the JAX ``MultipassPIV(
  use_pallas="off")`` at 256x256 within the port's parity budget (less than
  2% validation-mask mismatch, RMS < 0.01 px on jointly valid vectors);
  ``fused="split"`` and ``peakfit="pallas"`` against the JAX engine's
  unfused ``"off"`` chain, because the JAX package runs its Pallas
  correlate-and-fit and peak-fit kernels on the CPU only interpreted, and
  ``pallas_interpret=True`` would also select its shift kernel: its split
  windows are the same XLA shift, and the port's two kernels match the
  unfused chain (``test_torch_corrfit.py``, ``test_torch_engine.py``);
* the fault that this path repairs: with a predictor beyond ``max_shift``
  the port's ``"off"`` equals the JAX ``"off"`` and differs from the port's
  ``"auto"``;
* which path the engine takes (no kernel wrapper called under ``"off"`` or
  beyond the kernels' limits, the kernels at the limits themselves);
* the window-row split of ``parallel.ShardedPIV`` under ``"off"`` against
  the unsharded engine and the JAX ``ShardedPIV``'s XLA path;
* the public names of ``torchpiv_tpu/`` against the port's (an AST walk):
  only the TPU-only names are missing.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.models import MultipassPIV as JaxMultipassPIV
from torchpiv_tpu.models import PIVConfig as JaxPIVConfig
from torchpiv_tpu.ops import shifts as jax_shifts
from torchpiv_tpu.ops import windows as jax_windows
from torchpiv_tpu.parallel import ShardedPIV as JaxShardedPIV
from torchpiv_tpu.parallel import make_mesh as jax_make_mesh
from torchpiv_tpu.utils import persistence as jax_persistence
from torchpiv_tpu_torch import MultipassPIV, PIVConfig
from torchpiv_tpu_torch.models import multipass as port_multipass
from torchpiv_tpu_torch.ops import shifts, windows
from torchpiv_tpu_torch.ops.deform import def_windows_xla
from torchpiv_tpu_torch.ops.geometry import per_window_origins
from torchpiv_tpu_torch.parallel import ShardedPIV, make_mesh
from torchpiv_tpu_torch.utils import free_device_memory
from torchpiv_tpu_torch.utils.persistence import atoi, natural_keys
from torchpiv_tpu_torch.utils.synthetic import particle_pair, shear_flow

REPO = pathlib.Path(__file__).resolve().parents[1]
SHAPE = (256, 256)
BASE = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2)
CPU = torch.device("cpu")

# frames 48 x 56, w16/o8: a 5 x 6 window grid
GEOM = ((48, 56), 16, 8)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0),
          "float16": (torch.float16, jnp.float16, 0.25)}

# public top-level names of torchpiv_tpu/ with no counterpart in the port:
# TPU lowerings (the MXU DFT, the AOT-compiled packed scan) and the Pallas
# entry points, whose counterparts live under torchpiv_tpu_torch/kernels/
TPU_ONLY = {"aot_compile_packed", "build_packed_scan", "correlate_matmul",
            "correlate_peakfit_pallas", "correlation_to_displacement_pallas",
            "def_windows_pallas", "make_group_corrfit", "shift_windows_pallas"}


def _inputs(per_pixel, seed=0, B=2):
    """Frames, origins and shifts of ``GEOM``: N(0, 12) px shifts reach past
    ``w/2 = 8`` and out of the frame; three columns of integer shifts."""
    (H, W), w, o = GEOM
    r0, c0 = per_window_origins((H, W), w, o)
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (B, H, W)).astype(np.float32)
    shape = (B, r0.size, w, w) if per_pixel else (B, r0.size)
    vx, vy = (rng.normal(0.0, 12.0, shape).astype(np.float32) for _ in range(2))
    vx[..., :3] = np.round(vx[..., :3])
    return frame, r0, c0, vx, vy


def _jax_each(fn, frame, *args):
    """The JAX function (one frame at a time) over the batch, as float32."""
    return np.stack([np.asarray(fn(jnp.asarray(frame[b]), *(a(b) for a in args)))
                     .astype(np.float32) for b in range(frame.shape[0])])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,per_pixel", [
    ("cws_shift", False), ("cws_shift", True), ("bicubic_cws_shift", False),
    ("bicubic_cws_shift", True), ("dws_shift", False)])
def test_xla_shifts_match_jax(name, per_pixel, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    frame, r0, c0, vx, vy = _inputs(per_pixel)
    w = GEOM[1]
    got = getattr(shifts, name)(torch.from_numpy(frame), torch.from_numpy(r0),
                                torch.from_numpy(c0), w, torch.from_numpy(vx),
                                torch.from_numpy(vy), tdt)
    assert got.dtype == tdt and got.shape == (2, r0.size, w, w)
    want = _jax_each(
        lambda f, vxb, vyb: getattr(jax_shifts, name)(
            f, jnp.asarray(r0), jnp.asarray(c0), w, vxb, vyb, jdt),
        frame, lambda b: jnp.asarray(vx[b]), lambda b: jnp.asarray(vy[b]))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    # one frame without the batch axis is the batch's first
    one = getattr(shifts, name)(torch.from_numpy(frame[0]), torch.from_numpy(r0),
                                torch.from_numpy(c0), w, torch.from_numpy(vx[0]),
                                torch.from_numpy(vy[0]), tdt)
    assert torch.equal(one, got[0])


def test_xla_shift_wraps_on_the_flat_frame():
    """A window pushed off the right edge reads the next row's head, and one
    pushed before the first pixel reads pixel 0 (the clamp on the flat
    index), with no clamp to ``max_shift``."""
    frame = torch.arange(48 * 56, dtype=torch.float32).reshape(48, 56)
    r0, c0 = (torch.tensor([v], dtype=torch.int32) for v in (8, 40))
    right = shifts.dws_shift(frame, r0, c0, 16, torch.tensor([10]), torch.tensor([0]))
    assert right[0, 0, 0] == 8 * 56 + 50 and right[0, 0, 15] == 9 * 56 + 9
    before = shifts.cws_shift(frame, r0, c0, 16, torch.tensor([-100.0]),
                              torch.tensor([-30.0]))
    assert before[0, 0, 0] == 0.0


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_def_windows_xla_matches_the_jax_dense_path(interp):
    frame, r0, c0, vx, vy = _inputs(per_pixel=False, seed=4)
    w = GEOM[1]
    rng = np.random.default_rng(5)
    grads = [rng.uniform(-0.2, 0.2, vx.shape).astype(np.float32) for _ in range(4)]
    maps = [vx, vy] + grads
    got = def_windows_xla(torch.from_numpy(frame), torch.from_numpy(r0),
                          torch.from_numpy(c0), w,
                          *(torch.from_numpy(-m) for m in maps), interp=interp)
    off = jnp.arange(w, dtype=jnp.float32) - (w - 1) / 2.0

    def dense(center, gx, gy):  # torchpiv_tpu/models/multipass.py:790-795
        return (center[:, None, None] + gx[:, None, None] * off[None, None, :]
                + gy[:, None, None] * off[None, :, None])

    resample = (jax_shifts.bicubic_cws_shift if interp == "bicubic"
                else jax_shifts.cws_shift)
    u, v, dudx, dudy, dvdx, dvdy = maps
    want = _jax_each(
        lambda f, du, dv: resample(f, jnp.asarray(r0), jnp.asarray(c0), w, -du, -dv),
        frame, lambda b: dense(jnp.asarray(u[b]), jnp.asarray(dudx[b]), jnp.asarray(dudy[b])),
        lambda b: dense(jnp.asarray(v[b]), jnp.asarray(dvdx[b]), jnp.asarray(dvdy[b])))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape,w,o", [((48, 56), 16, 8), ((256, 256), 64, 32),
                                        ((100, 130), 24, 12), ((64, 64), 32, 0)])
def test_window_indices_equal_jax(shape, w, o):
    for got, want in zip(windows.window_index_1d(shape, w, o),
                         jax_windows.window_index_1d(shape, w, o)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got, want = windows.flat_window_grid(shape, w, o), jax_windows.flat_window_grid(shape, w, o)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _rms(a, b, valid):
    d = np.asarray(a, np.float64)[valid] - np.asarray(b, np.float64)[valid]
    return float(np.sqrt(np.mean(d ** 2)))


def _assert_parity(got, want):
    (u, v, inval), (ru, rv, rinval) = got, want
    assert u.shape == ru.shape
    assert np.mean(inval != rinval) < 0.02
    both = ~(inval | rinval)
    assert both.mean() > 0.5
    assert _rms(u, ru, both) < 0.01 and _rms(v, rv, both) < 0.01


def _port(kw, fa, fb):
    eng = MultipassPIV(PIVConfig(**kw), device="cpu")
    return tuple(t.numpy() for t in eng(torch.from_numpy(fa), torch.from_numpy(fb)))


def _jax(kw, fa, fb):
    return tuple(np.asarray(t) for t in JaxMultipassPIV(JaxPIVConfig(**kw))(
        jnp.asarray(fa), jnp.asarray(fb)))


OFF_PATHS = {
    "cws": dict(multipass_mode="CWS"),
    "dws": dict(multipass_mode="DWS"),
    "def": dict(multipass_mode="DEF"),
    "def-bicubic": dict(multipass_mode="DEF", cws_interp="bicubic"),
    "cws-bicubic": dict(cws_interp="bicubic"),
    "split": dict(fused="split"),
    "dws-split": dict(multipass_mode="DWS", fused="split"),
    "def-split": dict(multipass_mode="DEF", fused="split"),
    "peakfit-pallas": dict(peakfit="pallas"),
    "three-passes": dict(wind_size=128, overlap=64, multipass=3),
}
# what the JAX engine runs only through an interpreted Pallas kernel
JAX_UNFUSED = ("fused", "peakfit")


@pytest.mark.parametrize("flow", ["uniform", "shear"])
@pytest.mark.parametrize("path", sorted(OFF_PATHS))
def test_engine_off_matches_jax_off(path, flow):
    disp = (3.3, -2.1) if flow == "uniform" else shear_flow(1.0, 0.03)
    fa, fb = particle_pair(SHAPE, disp, seed=7)
    kw = dict(BASE, **OFF_PATHS[path], use_pallas="off")
    want = _jax({k: v for k, v in kw.items() if k not in JAX_UNFUSED}, fa, fb)
    _assert_parity(_port(kw, fa, fb), want)


def test_off_repairs_the_predictor_beyond_max_shift():
    """The fault: with ``max_shift=2`` and a 7.3 px displacement the
    kernels clamp the 3.65 px half-shift, the XLA path does not.  The
    port's ``"off"`` took the kernels before; now it equals the JAX
    ``"off"`` and differs from the port's ``"auto"``."""
    fa, fb = particle_pair(SHAPE, (7.3, -5.1), seed=11)
    kw = dict(BASE, max_shift=2)
    off = _port(dict(kw, use_pallas="off"), fa, fb)
    _assert_parity(off, _jax(dict(kw, use_pallas="off"), fa, fb))
    auto = _port(kw, fa, fb)
    both = ~(off[2] | auto[2])
    assert _rms(off[0], auto[0], both) > 0.05 or np.mean(off[2] != auto[2]) > 0.05
    # on the CPU the JAX "auto" is its XLA path too: the port's "auto"
    # is the kernels' semantics (the TPU's), which the JAX interpreted
    # kernels give
    _assert_parity(auto, _jax(dict(kw, use_pallas="on", pallas_interpret=True), fa, fb))


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel wrapper ran on the XLA path")


@pytest.mark.parametrize("kw", [
    dict(use_pallas="off"),
    dict(use_pallas="off", multipass_mode="DWS"),
    dict(use_pallas="off", multipass_mode="DEF"),
    dict(use_pallas="off", fused="split"),
    dict(use_pallas="on", cws_interp="bicubic", shift_variant="mxu"),
    dict(frame_shape=(512, 512), wind_size=260, overlap=130),  # pass 2: 130 px
    dict(frame_shape=(512, 512), wind_size=252, overlap=126, cws_interp="bicubic"),
    dict(frame_shape=(512, 512), wind_size=252, overlap=126, multipass_mode="DEF"),
])
def test_xla_path_runs_no_kernel_wrapper(monkeypatch, kw):
    monkeypatch.setattr(port_multipass, "shift_windows", _refuse)
    monkeypatch.setattr(port_multipass, "def_windows", _refuse)
    cfg = PIVConfig(**dict(BASE, **kw))
    fa, fb = particle_pair(cfg.frame_shape, (3.3, -2.1), seed=3)
    u, v, inval = MultipassPIV(cfg, device="cpu")(torch.from_numpy(fa), torch.from_numpy(fb))
    assert (~inval).float().mean() > 0.5
    assert abs(float(u[~inval].mean()) - 3.3) < 0.1


@pytest.mark.parametrize("kw,wrapper", [
    (dict(), "shift_windows"),
    (dict(use_pallas="off", pallas_interpret=True), "shift_windows"),
    (dict(wind_size=250, overlap=124, cws_interp="bicubic"), "shift_windows"),
    (dict(wind_size=248, overlap=124, multipass_mode="DEF"), "def_windows"),
    (dict(frame_shape=(1024, 1024), wind_size=512, overlap=256, multipass=3),
     "shift_windows"),
])
def test_kernel_path_within_the_limits(monkeypatch, kw, wrapper):
    """``"auto"`` and ``pallas_interpret`` take the kernels, once a frame
    and pass; so do the limit cases (a 125 px bicubic window, a 129 px DEF
    tile) and pass 3 of a 512 -> 256 -> 128 run, whose pass 2 is beyond the
    limit."""
    calls = []
    real = getattr(port_multipass, wrapper)

    def spy(frame, *args, **kwargs):
        calls.append(kwargs["wind_size"])
        return real(frame, *args, **kwargs)

    monkeypatch.setattr(port_multipass, wrapper, spy)
    cfg = PIVConfig(**{**BASE, "frame_shape": (512, 512), **kw})
    fa, fb = particle_pair(cfg.frame_shape, (3.3, -2.1), seed=3)
    MultipassPIV(cfg, device="cpu")(torch.from_numpy(fa), torch.from_numpy(fb))
    want = [w for w, _ in cfg.pass_schedule()[1:] if w <= 128]
    assert calls == [w for w in want for _ in range(2)]


@pytest.mark.parametrize("cfg_kw", [{}, {"multipass_mode": "DWS"},
                                    {"multipass_mode": "DEF"},
                                    {"cws_interp": "bicubic"}],
                         ids=["cws", "dws", "def", "bicubic"])
def test_window_split_off_matches_the_engine_and_jax(cfg_kw):
    pairs = [particle_pair(SHAPE, d, seed=s) for d, s in (((3.3, -2.1), 1), ((1.0, 0.5), 2))]
    fa, fb = (np.stack([p[i] for p in pairs]) for i in (0, 1))
    kw = dict(BASE, **cfg_kw, use_pallas="off")
    eng = MultipassPIV(PIVConfig(**kw), device="cpu")
    ta, tb = torch.from_numpy(fa), torch.from_numpy(fb)
    want = tuple(t.numpy() for t in eng(ta, tb))
    for axes in ({"pairs": 1, "windows": 2}, {"pairs": 2, "windows": 3}):
        got = ShardedPIV(eng, make_mesh(axes, [CPU] * 6))(ta, tb)
        _assert_parity(tuple(t.numpy() for t in got), want)
    jeng = JaxMultipassPIV(JaxPIVConfig(**kw))
    axes = {"pairs": 2, "windows": 2}
    jout = jax.jit(JaxShardedPIV(jeng, jax_make_mesh(axes)))(jnp.asarray(fa), jnp.asarray(fb))
    got = ShardedPIV(eng, make_mesh(axes, [CPU] * 4))(ta, tb)
    _assert_parity(tuple(t.numpy() for t in got), tuple(np.asarray(t) for t in jout))


def _public_names(root):
    names = set()
    for path in (REPO / root).rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                    and not node.name.startswith("_"):
                names.add(node.name)
    return names


def test_only_tpu_only_names_are_missing_from_the_port():
    missing = _public_names("torchpiv_tpu") - _public_names("torchpiv_tpu_torch")
    assert missing == TPU_ONLY


def test_small_helpers():
    for text in ("12", "a", "", "3b", "007"):
        assert atoi(text) == jax_persistence.atoi(text)
    names = ["p10_a.bmp", "p2_a.bmp", "p1_b.bmp", "q", "p1_a.bmp"]
    assert sorted(names, key=natural_keys) == sorted(names, key=jax_persistence.natural_keys)
    free_device_memory()  # nothing to release without a card; it must not raise
