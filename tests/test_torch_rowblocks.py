"""Row blocks (``row_start``/``n_rows_local``) in the plain versions of the
seven window-resampling kernels and in the models of their lanes: every
block ``torch.equal`` to the same rows of the full call (the first block, a
middle one and the last, clamped block of ``ShardedPIV``'s layout;
flat-wrap on and off), and the blocks against the TPU kernels they replace
(``shift_windows_pallas``/``def_windows_pallas(..., row_start=,
n_rows_local=, interpret=True)``) within the tolerances of
``test_torch_shift.py``, ``test_torch_variants.py`` and
``test_torch_deform.py``: integer shifts bit for bit, fractional ones
within 1e-4 of a grey level (XLA's CPU backend may contract the blend's
multiply-adds); the deformation on 99.5% of the pixels within 1e-3 (a
contracted residual may move a pixel across a cell)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.kernels.def_pallas import def_windows_pallas
from torchpiv_tpu.kernels.shift_pallas import shift_windows_pallas
from torchpiv_tpu_torch.kernels.deform import def_windows
from torchpiv_tpu_torch.kernels.shift import shift_windows
from torchpiv_tpu_torch.ops.deform import (def_block_steps, def_operands,
                                           def_reference, def_windows_reference)
from torchpiv_tpu_torch.ops.shifts import (blend_reference, blend_reference_bicubic,
                                           blend_reference_variant, shift_operands,
                                           shift_windows_reference, warp_bicubic_steps,
                                           warp_window_steps)
from torchpiv_tpu_torch.parallel.sharded import _block_layout

# (frame shape, window, overlap) of the shifts (a 7 x 10 window grid) and
# of the deformation (5 x 3: the interpreted DEF kernel unrolls its columns)
GEOMETRY = {"shift": ((64, 88), 16, 8), "def": ((96, 64), 32, 16)}


def _grid(kind):
    (H, Wd), w, o = GEOMETRY[kind]
    return (H - w) // (w - o) + 1, (Wd - w) // (w - o) + 1


def _blocks(kind):
    """``(rloc, {where: row_start})``: ``ShardedPIV``'s four clamped
    blocks, the last one overlapping its neighbour."""
    rloc, origins, _ = _block_layout(_grid(kind)[0], 4)
    assert origins[-1] < origins[-2] + rloc  # clamped
    return rloc, {"first": 0, "middle": int(origins[1]), "last": int(origins[-1])}


@functools.lru_cache(maxsize=None)
def _inputs(kind, seed=3):
    (shape, w, _), (R, C) = GEOMETRY[kind], _grid(kind)
    rng = np.random.default_rng(seed)
    frame = torch.from_numpy(rng.uniform(0, 255, (1, *shape)).astype(np.float32))
    reach = 1.5 * w  # past the +-S = w/2 clamp
    vel = [torch.from_numpy(rng.uniform(-reach, reach, (1, R * C)).astype(np.float32))
           for _ in range(2)]
    grads = [torch.from_numpy(rng.uniform(-0.05, 0.05, (1, R * C)).astype(np.float32))
             for _ in range(4)]
    return frame, vel, grads


def _rows(kind, m, r0, n):
    C = _grid(kind)[1]
    return m[:, r0 * C:(r0 + n) * C]


SHIFTS = {
    "blend_reference": ("bilinear", blend_reference),
    "blend_reference_bicubic": ("bicubic", blend_reference_bicubic),
    "warp_window_steps": ("bilinear", warp_window_steps),
    "warp_bicubic_steps": ("bicubic", warp_bicubic_steps),
    **{f"variant-{v}": ("bilinear", functools.partial(blend_reference_variant, variant=v))
       for v in ("bf16", "lanephases", "mxu", "phases")},
}
DEFORMS = {"def_reference": ("bilinear", def_reference),
           "def_reference-bicubic": ("bicubic", def_reference),
           "def_block_steps": ("bilinear", def_block_steps),
           "def_block_steps-bicubic": ("bicubic", def_block_steps)}


@functools.lru_cache(maxsize=None)
def _full(name, flat_wrap):
    return _block(name, flat_wrap, 0, None)


def _block(name, flat_wrap, r0, n):
    kind = "shift" if name in SHIFTS else "def"
    frame, vel, grads = _inputs(kind)
    shape, w, o = GEOMETRY[kind]
    rows = _grid(kind)[0] - r0 if n is None else n
    block = dict(row_start=r0, n_rows_local=n)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, flat_wrap=flat_wrap)
    if kind == "shift":
        interp, fn = SHIFTS[name]
        ops = shift_operands(frame, *(_rows(kind, m, r0, rows) for m in vel),
                             interp=interp, **kw, **block)
        return fn(ops, w)
    interp, fn = DEFORMS[name]
    ops = def_operands(frame, *(_rows(kind, m, r0, rows) for m in vel + grads),
                       margin=2, interp=interp, **kw, **block)
    return fn(ops, w)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("flat_wrap", [True, False], ids=["flat_wrap", "clamped"])
@pytest.mark.parametrize("name", list(SHIFTS) + list(DEFORMS))
def test_block_equals_the_rows_of_the_full_call(name, flat_wrap, where):
    kind = "shift" if name in SHIFTS else "def"
    rloc, blocks = _blocks(kind)
    w = GEOMETRY[kind][1]
    got = _block(name, flat_wrap, blocks[where], rloc)
    assert got.shape == (1, rloc * _grid(kind)[1], w, w)
    assert torch.equal(got, _rows(kind, _full(name, flat_wrap), blocks[where], rloc))


def test_default_block_is_the_whole_grid_and_bad_blocks_raise():
    frame, (vx, vy), _ = _inputs("shift")
    shape, w, o = GEOMETRY["shift"]
    R, C = _grid("shift")
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    whole = shift_windows_reference(frame, vx, vy, **kw)
    assert torch.equal(shift_windows_reference(frame, vx, vy, row_start=0,
                                               n_rows_local=R, **kw), whole)
    # the rest of the grid from row_start on, through the CPU wrapper
    tail = shift_windows(frame, _rows("shift", vx, 4, R - 4),
                         _rows("shift", vy, 4, R - 4), row_start=4, **kw)
    assert torch.equal(tail, _rows("shift", whole, 4, R - 4))
    assert shift_operands(frame, vx, vy, **kw).row_start == 0
    for r0, n in ((-1, 3), (R - 2, 3), (0, 0), (0, R + 1)):
        with pytest.raises(ValueError, match="row block"):
            shift_windows(frame, vx[:, :max(n, 1) * C], vy[:, :max(n, 1) * C],
                          row_start=r0, n_rows_local=n, **kw)
    with pytest.raises(ValueError, match="per-window maps"):
        shift_windows(frame, vx, vy, row_start=2, n_rows_local=3, **kw)


def test_def_wrapper_takes_a_block_on_cpu():
    frame, vel, grads = _inputs("def")
    shape, w, o = GEOMETRY["def"]
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    full = def_windows_reference(frame, *vel, *grads, **kw)
    got = def_windows(frame, *(_rows("def", m, 3, 2) for m in vel + grads),
                      row_start=3, n_rows_local=2, **kw)
    assert torch.equal(got, _rows("def", full, 3, 2))


# one TPU kernel a case: all eight with the tile clamped to the frame (no
# flat-wrap pad: where a moved frame pointer would show), the three base
# kernels with the pad too
PALLAS = [("rolls", False), ("bicubic", False), ("bf16", False), ("lanephases", False),
          ("mxu", False), ("phases", False), ("def", False), ("def-bicubic", False),
          ("rolls", True), ("bicubic", True), ("def", True)]


@pytest.mark.parametrize("kind,flat_wrap", PALLAS,
                         ids=[f"{k}-{'flat_wrap' if f else 'clamped'}" for k, f in PALLAS])
def test_last_block_matches_the_pallas_kernel(kind, flat_wrap):
    geometry = "def" if kind.startswith("def") else "shift"
    frame, vel, grads = _inputs(geometry)
    shape, w, o = GEOMETRY[geometry]
    rloc, blocks = _blocks(geometry)
    r0 = blocks["last"]
    f0 = frame[0]
    if geometry == "def":
        maps = [_rows(geometry, m, r0, rloc)[0] for m in vel + grads]
        kw = dict(frame_shape=shape, wind_size=w, overlap=o, flat_wrap=flat_wrap,
                  interp="bicubic" if kind == "def-bicubic" else "bilinear",
                  row_start=r0, n_rows_local=rloc)
        want = np.asarray(def_windows_pallas(
            jnp.asarray(f0.numpy()), *(jnp.asarray(m.numpy()) for m in maps),
            interpret=True, **kw))
        got = def_windows_reference(f0, *maps, **kw).numpy()
        d = np.abs(got - want)
        assert (d <= 1e-3).mean() >= 0.995 and d.max() <= 255.0
        return
    # 8-bit grey levels: exact in bfloat16, as the variants' tests take them
    f0 = f0.round()
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, flat_wrap=flat_wrap,
              row_start=r0, n_rows_local=rloc)
    if kind == "bicubic":
        kw["interp"] = "bicubic"
    elif kind != "rolls":
        kw["variant"] = kind
    vx, vy = (_rows(geometry, m, r0, rloc)[0] for m in vel)
    for label, (sx, sy) in (("fractional", (vx, vy)), ("integer", (vx.round(), vy.round()))):
        want = np.asarray(shift_windows_pallas(
            jnp.asarray(f0.numpy()), jnp.asarray(sx.numpy()), jnp.asarray(sy.numpy()),
            interpret=True, **kw))
        got = shift_windows_reference(f0, sx, sy, **kw).numpy()
        assert got.shape == want.shape == (rloc * _grid(geometry)[1], w, w)
        if label == "integer":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
