"""The work split of the window-resampling kernels, on the CPU: the step
models ``ops.shifts.warp_window_steps`` (``csrc/shift_windows.cu``, and
``csrc/shift_windows_phases.cu`` on the frame rounded to bfloat16: a warp a
window, rows in registers, right neighbours by shuffle),
``ops.shifts.warp_bicubic_steps`` (``csrc/shift_windows_bicubic.cu``: the
same lane map with the tile's last three columns in an extra slot, three
shuffles a slot, the horizontal sums once per tile row in a ring of four
rows) and
``ops.deform.def_block_steps`` (``csrc/def_windows.cu``: a block walks eight
windows of a grid row through two tile buffers, a thread a column quad,
the residuals' row and column parts hoisted, each Keys weight the piece its
tap fixes) replay
which lane or thread computes which pixel from which loaded row, shuffled
neighbour, hoisted residual and Keys piece.  They are held bit
for bit (``torch.equal``) to the plain versions ``blend_reference`` and
``def_reference`` (and ``blend_reference_bicubic``,
``blend_reference_variant(..., "phases")``), at every width the kernels
serve differently, on ragged
grids, and once against the TPU kernels they replace
(``shift_windows_pallas``, bilinear and bicubic, and ``def_windows_pallas``
in interpret mode) with the tolerances of ``test_torch_shift.py`` and
``test_torch_deform.py``.
The kernels themselves are held against the plain versions on a card in
``test_torch_cuda.py``."""
import importlib.util
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.kernels.def_pallas import def_windows_pallas
from torchpiv_tpu.kernels.shift_pallas import shift_windows_pallas
from torchpiv_tpu_torch.kernels.deform import MAX_DEF_TILE, def_tile
from torchpiv_tpu_torch.kernels.shift import MAX_BICUBIC_WIND, MAX_SHIFT_WIND
from torchpiv_tpu_torch.kernels import _build
from torchpiv_tpu_torch.ops.deform import (BLOCK_WINDOWS, block_geometry,
                                           def_block_steps, def_operands,
                                           def_reference, keys_tap,
                                           keys_weight)
from torchpiv_tpu_torch.ops.packing import pack_windows
from torchpiv_tpu_torch.ops.shifts import (WARPS, blend_reference,
                                           blend_reference_bicubic,
                                           blend_reference_variant,
                                           shift_operands, warp_bicubic_steps,
                                           warp_lanes, warp_window_steps)

# every width the shift kernel serves differently: several windows a warp
# (w <= 16), idle lanes (12, 24), one to four columns a lane (32-128)
WIDTHS = (4, 8, 12, 16, 24, 32, 48, 64, 128)
# every width where the bicubic kernel's lane map differs: several windows a
# warp (4-16), idle lanes (12, 24), a group one lane short of the stencil's
# three extra columns (31), one to four columns a lane with and without the
# extra slot (32-125)
BICUBIC_WIDTHS = (4, 8, 12, 16, 24, 31, 32, 33, 48, 64, 96, 125)
# (w, margin) of the DEF kernel: margins 1-4, an odd width, tiles up to 129
DEF_CASES = ((4, 1), (8, 2), (12, 3), (16, 4), (24, 2), (32, 2), (33, 1),
             (48, 3), (64, 4), (120, 4))


def _grid_shape(w, o, per_block, n_rows=2):
    """A frame of ``n_rows`` window rows whose column count leaves the last
    block of a row part empty."""
    step = w - o
    n_cols = per_block + 3
    return w + step * (n_rows - 1) + step - 1, w + step * (n_cols - 1) + step - 1


def _windows_a_block(w, reach=1):
    G, _ = warp_lanes(w, reach)
    return WARPS * (32 // G)


def _maps(rng, batch, n, w, kind):
    """Shifts of ``chip_smoke.py::shift_cases``' kinds, past the +-S = w/2
    clamp."""
    vx = rng.uniform(-1.5 * w, 1.5 * w, (batch, n)).astype(np.float32)
    vy = rng.uniform(-1.5 * w, 1.5 * w, (batch, n)).astype(np.float32)
    if kind == "integer":
        vx, vy = np.round(vx), np.round(vy)
    elif kind == "mixed":  # integer in one axis: the floor corner
        vx = np.round(vx)
    return vx, vy


def _shift_case(w, kind, batch, seed, n_rows=2, reach=1):
    o = w // 2
    shape = _grid_shape(w, o, _windows_a_block(w, reach), n_rows)
    n = ((shape[0] - w) // (w - o) + 1) * ((shape[1] - w) // (w - o) + 1)
    rng = np.random.default_rng(seed)
    frame = rng.uniform(0, 255, (batch, *shape)).astype(np.float32)
    return shape, o, frame, *_maps(rng, batch, n, w, kind)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", ["integer", "mixed", "fractional"])
@pytest.mark.parametrize("w", WIDTHS)
def test_warp_window_steps_equal_blend_reference(w, kind, batch):
    shape, o, frame, vx, vy = _shift_case(w, kind, batch, seed=w)
    ops = shift_operands(*(torch.from_numpy(a) for a in (frame, vx, vy)),
                         frame_shape=shape, wind_size=w, overlap=o)
    assert ops.n_cols % _windows_a_block(w) != 0  # a ragged last block
    assert torch.equal(warp_window_steps(ops, w), blend_reference(ops, w))


@pytest.mark.parametrize("kind", ["integer", "fractional"])
@pytest.mark.parametrize("w", WIDTHS)
def test_warp_window_steps_packed_equal_packed_reference(w, kind):
    shape, o, frame, vx, vy = _shift_case(w, kind, 3, seed=w + 1)
    ops = shift_operands(*(torch.from_numpy(a) for a in (frame, vx, vy)),
                         frame_shape=shape, wind_size=w, overlap=o)
    want = pack_windows(blend_reference(ops, w), ops.n_rows, ops.n_cols, w)
    got = warp_window_steps(ops, w, packed=True)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("kw", [dict(max_shift=5), dict(flat_wrap=False)])
def test_warp_window_steps_options(kw):
    shape, o, frame, vx, vy = _shift_case(32, "fractional", 1, seed=3)
    ops = shift_operands(*(torch.from_numpy(a) for a in (frame, vx, vy)),
                         frame_shape=shape, wind_size=32, overlap=o, **kw)
    assert torch.equal(warp_window_steps(ops, 32), blend_reference(ops, 32))


def test_warp_lanes_cover_every_admitted_width():
    """Every width up to ``MAX_SHIFT_WIND``: a group is a power of two of
    lanes that divides the warp, and its lanes' slots hold every tile
    column once, the last one in lane 0's extra slot where needed."""
    for w in range(1, MAX_SHIFT_WIND + 1):
        G, K = warp_lanes(w)
        assert G & (G - 1) == 0 and 32 % G == 0 and K <= 4
        assert G * K >= w and (K == 1 or G == 32)
        cols = sorted(c + G * k for c in range(G) for k in range(K + 1)
                      if c + G * k <= w)
        assert cols == list(range(w + 1))


@pytest.mark.parametrize("kind", ["integer", "mixed", "fractional"])
def test_warp_window_steps_match_pallas_kernel(kind):
    """Through the TPU kernel the model replaces, on the same numpy inputs:
    integer and mixed shifts bit for bit, fractional ones within 1e-4 of a
    grey level (XLA's CPU backend may contract the blend's multiply-adds)."""
    w = 16
    shape, o, frame, vx, vy = _shift_case(w, kind, 1, seed=21, n_rows=3)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    want = np.asarray(shift_windows_pallas(
        jnp.asarray(frame[0]), jnp.asarray(vx[0]), jnp.asarray(vy[0]),
        interpret=True, **kw))
    ops = shift_operands(*(torch.from_numpy(a) for a in (frame, vx, vy)), **kw)
    got = warp_window_steps(ops, w)[0].numpy()
    assert got.shape == want.shape
    if kind == "fractional":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["integer", "mixed", "fractional"])
@pytest.mark.parametrize("w", WIDTHS)
def test_warp_window_steps_model_the_phases_kernel(w, kind):
    """``shift_windows_phases.cu`` runs the bilinear kernel's steps on the
    padded frame rounded to bfloat16: the model on that frame is the plain
    version of ``"phases"``."""
    shape, o, frame, vx, vy = _shift_case(w, kind, 3, seed=w + 5)
    frame = frame * np.float32(0.731) + np.float32(0.37)  # not exact in bfloat16
    ops = shift_operands(*(torch.from_numpy(a) for a in (frame, vx, vy)),
                         frame_shape=shape, wind_size=w, overlap=o)
    rounded = ops._replace(frame=ops.frame.to(torch.bfloat16).to(torch.float32))
    want = blend_reference_variant(ops, w, "phases")
    assert torch.equal(warp_window_steps(rounded, w), want)
    assert not torch.equal(want, blend_reference(ops, w))


def _bicubic_ops(w, kind, batch, seed, n_rows=2, **kw):
    shape, o, frame, vx, vy = _shift_case(w, kind, batch, seed, n_rows, reach=3)
    return shift_operands(*(torch.from_numpy(a) for a in (frame, vx, vy)),
                          frame_shape=shape, wind_size=w, overlap=o,
                          interp="bicubic", **kw)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", ["integer", "mixed", "fractional"])
@pytest.mark.parametrize("w", BICUBIC_WIDTHS)
def test_warp_bicubic_steps_equal_blend_reference_bicubic(w, kind, batch):
    ops = _bicubic_ops(w, kind, batch, seed=w + 2)
    assert ops.n_cols % _windows_a_block(w, reach=3) != 0  # a ragged last block
    assert torch.equal(warp_bicubic_steps(ops, w), blend_reference_bicubic(ops, w))


@pytest.mark.parametrize("kw", [dict(max_shift=5), dict(flat_wrap=False)])
def test_warp_bicubic_steps_options(kw):
    ops = _bicubic_ops(32, "fractional", 1, seed=4, **kw)
    assert torch.equal(warp_bicubic_steps(ops, 32), blend_reference_bicubic(ops, 32))


def test_bicubic_lane_map_covers_every_admitted_width():
    """Every width up to ``MAX_BICUBIC_WIND``: a group is a power of two of
    lanes that divides the warp and is at least the stencil's reach of 3;
    its lanes' slots hold every tile column the stencil reads (0..w+2) once,
    the ones past the main slots in the extra slot of the group's first
    lanes; and each column j + d (d = 1..3) that a slot's column j needs is
    in the slot that the shuffle reads: lane (c + d) mod G's own, or, past
    the group's end, the next one, which that lane offers."""
    for w in range(1, MAX_BICUBIC_WIND + 1):
        G, K = warp_lanes(w, reach=3)
        assert G & (G - 1) == 0 and 32 % G == 0 and G >= 3 and K <= 4
        assert G * K >= w and (K == 1 or G == 32)
        held = {(c, k): c + G * k for c in range(G) for k in range(K + 1)
                if c + G * k <= w + 2}
        assert sorted(held.values()) == list(range(w + 3))
        assert all(c < 3 for (c, k) in held if k == K)
        for c in range(G):
            for k in range(K):
                if c + G * k >= w:
                    continue  # no output column: its sums are not stored
                for d in (1, 2, 3):
                    src = (c + d) % G
                    slot = k + 1 if c + d >= G else k
                    assert held[(src, slot)] == c + G * k + d


@pytest.mark.parametrize("kind", ["integer", "mixed", "fractional"])
def test_warp_bicubic_steps_match_pallas_kernel(kind):
    """Through the TPU kernel the model replaces, on the same numpy inputs,
    with ``test_torch_shift.py``'s tolerances: integer shifts bit for bit
    (the weights are (0, 1, 0, 0)), the others within 1e-3 of a grey level
    (XLA's CPU backend may contract the sums' multiply-adds)."""
    w = 16
    shape, o, frame, vx, vy = _shift_case(w, kind, 1, seed=23, n_rows=3, reach=3)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, interp="bicubic")
    want = np.asarray(shift_windows_pallas(
        jnp.asarray(frame[0]), jnp.asarray(vx[0]), jnp.asarray(vy[0]),
        interpret=True, **kw))
    ops = shift_operands(*(torch.from_numpy(a) for a in (frame, vx, vy)), **kw)
    got = warp_bicubic_steps(ops, w)[0].numpy()
    assert got.shape == want.shape
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _def_case(w, margin, kind, batch, seed, n_rows=2):
    o = w // 2
    shape = _grid_shape(w, o, BLOCK_WINDOWS, n_rows)
    n = ((shape[0] - w) // (w - o) + 1) * ((shape[1] - w) // (w - o) + 1)
    rng = np.random.default_rng(seed)
    frame = rng.uniform(0, 255, (batch, *shape)).astype(np.float32)
    vx, vy = _maps(rng, batch, n, w, "integer" if kind == "integer" else "fractional")
    slope = {"general": 0.05, "saturating": 0.6, "integer": 0.0}[kind]
    grads = [rng.uniform(-slope, slope, (batch, n)).astype(np.float32) for _ in range(4)]
    return shape, o, frame, [vx, vy, *grads]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", ["general", "saturating", "integer"])
@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
@pytest.mark.parametrize("w,margin", DEF_CASES)
def test_def_block_steps_equal_def_reference(w, margin, interp, kind, batch):
    if def_tile(w, margin, interp) > MAX_DEF_TILE:
        margin = 1  # the bicubic tile of w120: 120 + 2 + 4 = 126
    shape, o, frame, maps = _def_case(w, margin, kind, batch, seed=w + margin)
    ops = def_operands(torch.from_numpy(frame), *(torch.from_numpy(m) for m in maps),
                       frame_shape=shape, wind_size=w, overlap=o, margin=margin,
                       interp=interp)
    assert ops.n_cols % BLOCK_WINDOWS != 0  # a ragged last block
    assert torch.equal(def_block_steps(ops, w), def_reference(ops, w))


def test_block_geometry_serves_every_admitted_tile():
    """Every DEF window the tile limit admits: whole warps of at most 256
    threads, each active thread a column quad and a first row, the quads
    covering the row and the row passes every row once."""
    for w in range(1, MAX_DEF_TILE - 2):
        Q, R, threads = block_geometry(w)
        assert threads % 32 == 0 and Q * R <= threads <= 256
        assert 4 * Q >= w > 4 * (Q - 1) and 1 <= R <= w
        rows = sorted(p + R * m for p in range(R) for m in range(-(-w // R))
                      if p + R * m < w)
        assert rows == list(range(w))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_keys_tap_equals_keys_weight(k):
    """The piece a tap's position fixes is the one the branch form picks,
    or gives the same bits (+0 at |d| = 1 and 2 on taps 0 and 3): at the
    distances a residual in [0, 2M + 1) produces, integers and the floats
    next to them included."""
    r = torch.cat([torch.linspace(0.0, 8.999, 90001),
                   torch.arange(9, dtype=torch.float32)])
    r = torch.cat([r, torch.nextafter(r, torch.tensor(10.0)),
                   torch.nextafter(r, torch.tensor(-1.0)).clamp(min=0.0)])
    fr = torch.floor(r)
    d = (r + 1.0) - (fr + k)
    assert bool(((d.abs() <= 1.0) if k in (1, 2) else
                 ((d.abs() >= 1.0) & (d.abs() <= 2.0))).all())
    assert torch.equal(keys_tap(d, k), keys_weight(d))


@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_def_block_steps_match_pallas_kernel(interp):
    """Through the TPU kernel the model replaces, on the same numpy inputs,
    with ``test_torch_deform.py``'s tolerance: at least 99.5% of the pixels
    within 1e-3 of a grey level, all within 255 (XLA's CPU backend may
    contract the residual's multiply-adds and move a pixel on an integer
    coordinate into the next cell)."""
    w, margin = 16, 2
    shape, o, frame, maps = _def_case(w, margin, "general", 1, seed=31)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, margin=margin, interp=interp)
    want = np.asarray(def_windows_pallas(
        jnp.asarray(frame[0]), *(jnp.asarray(m[0]) for m in maps), interpret=True, **kw))
    ops = def_operands(torch.from_numpy(frame), *(torch.from_numpy(m) for m in maps), **kw)
    got = def_block_steps(ops, w)[0].numpy()
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d <= 1e-3).mean() >= 0.995
    assert d.max() <= 255.0


def test_def_anatomy_tool_edits_the_committed_source():
    """``tools/def_anatomy_cuda.py``: every edit of every mode matches the
    committed ``def_windows.cu`` once, ``full`` is the committed text, a
    copy holds the edited text, and the ptxas log is split by instance."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "def_anatomy_cuda.py"
    spec = importlib.util.spec_from_file_location("def_anatomy_cuda", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    committed = (_build.CSRC / "def_windows.cu").read_text()
    assert tool.SOURCES == _build.CSRC
    assert tool.edited_sources("full") == {"def_windows.cu": committed}
    assert set(tool.EDITS) == {"full", "stages1", "nostage", "nosample", "storeonly"}
    for mode in tool.EDITS:
        edited = tool.edited_sources(mode)["def_windows.cu"]
        assert (edited != committed) == (mode != "full"), mode
        copy = tool.edited_copy(mode)
        try:
            assert (copy / "def_windows.cu").read_text() == edited
            assert sorted(p.name for p in copy.iterdir()) == \
                sorted(p.name for p in _build.CSRC.iterdir())
        finally:
            shutil.rmtree(copy)
    assert "cp_async4" not in tool.edited_sources("storeonly")["def_windows.cu"].split(
        "auto stage")[1].split("};")[0]
    log = ("ptxas info    : Compiling entry function '_Z18def_windows_kernelILb1EEvPKf'\n"
           "ptxas info    : Used 80 registers, 380 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z18def_windows_kernelILb0EEvPKf'\n"
           "ptxas info    : Used 64 registers, 380 bytes cmem[0]\n")
    assert tool.instance_summary(log, cubic=False)["registers"] == 64
    assert tool.instance_summary(log, cubic=True)["registers"] == 80


def test_depth_tool_edits_the_committed_sources():
    """``tools/warp_shift_depth_cuda.py``: each depth of each kernel is a
    copy of the package's sources whose one-column ``rows_ahead`` is that
    depth and which differs from the committed source nowhere else; the
    committed depths are among those it times."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "warp_shift_depth_cuda.py"
    spec = importlib.util.spec_from_file_location("warp_shift_depth_cuda", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert set(tool.DEPTHS) == {"shift_windows_bicubic", "shift_windows_phases",
                                "shift_windows_bf16"}
    for name, depths in tool.DEPTHS.items():
        committed = (_build.CSRC / f"{name}.cu").read_text()
        assert int(tool.AHEAD.search(committed).group(1)) in depths
        if name == "shift_windows_bicubic":  # the ring: a multiple of 4 rows
            assert all(d % 4 == 0 for d in depths)
        for depth in depths:
            copy = tool.edited_copy(name, depth)
            try:
                edited = (copy / f"{name}.cu").read_text()
                assert tool.AHEAD.findall(edited) == [str(depth)]
                assert tool.AHEAD.sub("", edited) == tool.AHEAD.sub("", committed)
                assert sorted(p.name for p in copy.iterdir()) == \
                    sorted(p.name for p in _build.CSRC.iterdir())
            finally:
                shutil.rmtree(copy)
