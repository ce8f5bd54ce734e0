"""Window stores in bfloat16 and float16 (``out_dtype``) in the plain
versions of the window-shift and deformation kernels, against the TPU
kernels they replace (``shift_windows_pallas``/``def_windows_pallas(...,
out_dtype=, interpret=True)``): the bilinear and bicubic shifts, the packed
layout, row blocks, and the deformation with both interpolations.  Also
``fused_piv_pass``'s ``extract_mode`` and ``stub``.

Both sides compute in float32 and round only at the store, to nearest even:
each side's narrow store is array-equal to its own float32 result rounded
(``.to()``, ``.astype()``).  Integer and mixed shifts copy tile values (the
floor corner), so the two sides' narrow stores are array-equal.  For
fractional shifts the interpreted TPU kernels' float32 results already
differ from the plain versions' in the last bits (XLA's CPU backend may
contract the multiply-adds; ``test_torch_shift.py``, ``test_torch_deform.py``
hold them within 1e-4, 1e-3 and 99.5% within 1e-3 of a grey level): there
the narrow stores are array-equal wherever the two float32 results are, and
the float32 results are held within those tolerances.  The kernels on a
card are held to these plain versions bit for bit in
``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.experimental.fused_pass import fused_piv_pass as jax_fused_piv_pass
from torchpiv_tpu.kernels.def_pallas import def_windows_pallas
from torchpiv_tpu.kernels.shift_pallas import shift_windows_pallas
from torchpiv_tpu_torch.kernels.deform import def_windows
from torchpiv_tpu_torch.kernels.fused_pass import fused_piv_pass
from torchpiv_tpu_torch.kernels.shift import STORE_SYMBOLS, shift_windows
from torchpiv_tpu_torch.utils.synthetic import particle_pair

NARROW = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
NARROW_JAX = dict(NARROW.values())
SHAPE, W, O = (128, 128), 32, 16
N_ROWS = (SHAPE[0] - W) // (W - O) + 1
N = N_ROWS * ((SHAPE[1] - W) // (W - O) + 1)


def _frame(seed):
    return np.random.default_rng(seed).uniform(0, 255, SHAPE).astype(np.float32)


def _shifts(kind, n, seed, reach=1.5 * W):
    rng = np.random.default_rng(seed)
    vx = rng.uniform(-reach, reach, n).astype(np.float32)
    vy = rng.uniform(-reach, reach, n).astype(np.float32)
    if kind == "integer":
        vx, vy = np.round(vx), np.round(vy)
    elif kind == "mixed":  # integer in one axis: the floor corner
        vx = np.round(vx)
    return vx, vy


def _check_stores(got, want, got32, want32, dtype, exact, atol=None):
    """``got``/``want``: the port's and the TPU kernel's narrow stores (as
    float32 arrays); ``got32``/``want32``: their float32 results, which
    ``exact`` holds equal and ``atol`` within a tolerance."""
    assert got.shape == want.shape == got32.shape
    np.testing.assert_array_equal(
        got, torch.from_numpy(got32).to(dtype).float().numpy())
    np.testing.assert_array_equal(
        want, np.asarray(jnp.asarray(want32).astype(NARROW_JAX[dtype])).astype(np.float32))
    if exact:
        np.testing.assert_array_equal(got32, want32)
        np.testing.assert_array_equal(got, want)
        return
    same = got32 == want32
    np.testing.assert_array_equal(got[same], want[same])
    if atol is not None:
        np.testing.assert_allclose(got32, want32, rtol=0, atol=atol)


def _shift_pair(frame, vx, vy, name, **kw):
    tdt, jdt = NARROW[name]
    tf, tx, ty = (torch.from_numpy(a) for a in (frame, vx, vy))
    jf, jx, jy = (jnp.asarray(a) for a in (frame, vx, vy))
    got = shift_windows(tf, tx, ty, out_dtype=tdt, **kw)
    assert got.dtype == tdt
    got32 = shift_windows(tf, tx, ty, **kw).numpy()
    want = shift_windows_pallas(jf, jx, jy, interpret=True, out_dtype=jdt, **kw)
    assert want.dtype == jdt
    want32 = np.asarray(shift_windows_pallas(jf, jx, jy, interpret=True, **kw))
    return (got.float().numpy(), np.asarray(want).astype(np.float32), got32,
            want32, tdt)


@pytest.mark.parametrize("name", list(NARROW))
@pytest.mark.parametrize("interp,kind", [
    ("bilinear", "integer"), ("bilinear", "fractional"), ("bilinear", "mixed"),
    ("bicubic", "integer"), ("bicubic", "fractional")])
def test_plain_shift_stores_match_pallas_kernel(interp, kind, name):
    frame = _frame(1)
    vx, vy = _shifts(kind, N, seed=2)
    kw = dict(frame_shape=SHAPE, wind_size=W, overlap=O, interp=interp)
    got, want, got32, want32, tdt = _shift_pair(frame, vx, vy, name, **kw)
    _check_stores(got, want, got32, want32, tdt, exact=kind != "fractional",
                  atol=1e-4 if interp == "bilinear" else 1e-3)


@pytest.mark.parametrize("name", list(NARROW))
@pytest.mark.parametrize("kind", ["integer", "fractional"])
def test_plain_packed_stores_match_pallas_kernel(kind, name):
    shape, w, o = (64, 88), 16, 8  # 10 windows a row: a tail of 6 lanes
    n = ((shape[0] - w) // (w - o) + 1) * ((shape[1] - w) // (w - o) + 1)
    frame = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    vx, vy = _shifts(kind, n, seed=4, reach=1.5 * w)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, packed=True)
    got, want, got32, want32, tdt = _shift_pair(frame, vx, vy, name, **kw)
    _check_stores(got, want, got32, want32, tdt, exact=kind == "integer", atol=1e-4)


@pytest.mark.parametrize("name", list(NARROW))
@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_plain_row_block_stores_match_pallas_kernel(interp, name):
    r0, rloc = 2, 3
    C = N // N_ROWS
    frame = _frame(5)
    vx, vy = _shifts("fractional", rloc * C, seed=6)
    kw = dict(frame_shape=SHAPE, wind_size=W, overlap=O, interp=interp,
              row_start=r0, n_rows_local=rloc)
    got, want, got32, want32, tdt = _shift_pair(frame, vx, vy, name, **kw)
    assert got.shape == (rloc * C, W, W)
    _check_stores(got, want, got32, want32, tdt, exact=False,
                  atol=1e-4 if interp == "bilinear" else 1e-3)
    # the block's stores are the full call's rows
    vfx, vfy = (np.zeros(N, np.float32) for _ in range(2))
    vfx[r0 * C:(r0 + rloc) * C], vfy[r0 * C:(r0 + rloc) * C] = vx, vy
    full = shift_windows(torch.from_numpy(frame), torch.from_numpy(vfx),
                         torch.from_numpy(vfy), frame_shape=SHAPE, wind_size=W,
                         overlap=O, interp=interp, out_dtype=tdt)
    assert torch.equal(full[r0 * C:(r0 + rloc) * C].float(), torch.from_numpy(got))


@pytest.mark.parametrize("name", list(NARROW))
@pytest.mark.parametrize("interp", ["bilinear", "bicubic"])
def test_plain_deformation_stores_match_pallas_kernel(interp, name):
    tdt, jdt = NARROW[name]
    shape = (96, 64)  # 5 x 3 windows: the interpreted kernel unrolls its taps
    n = ((shape[0] - W) // (W - O) + 1) * ((shape[1] - W) // (W - O) + 1)
    frame = np.random.default_rng(7).uniform(0, 255, shape).astype(np.float32)
    rng = np.random.default_rng(8)
    maps = [rng.uniform(-12, 12, n).astype(np.float32) for _ in range(2)]
    maps += [rng.uniform(-0.3, 0.3, n).astype(np.float32) for _ in range(4)]
    kw = dict(frame_shape=shape, wind_size=W, overlap=O, interp=interp)
    tmaps = [torch.from_numpy(m) for m in maps]
    jmaps = [jnp.asarray(m) for m in maps]
    got = def_windows(torch.from_numpy(frame), *tmaps, out_dtype=tdt, **kw)
    assert got.dtype == tdt
    got32 = def_windows(torch.from_numpy(frame), *tmaps, **kw).numpy()
    want = def_windows_pallas(jnp.asarray(frame), *jmaps, interpret=True,
                              out_dtype=jdt, **kw)
    assert want.dtype == jdt
    want32 = np.asarray(def_windows_pallas(jnp.asarray(frame), *jmaps,
                                           interpret=True, **kw))
    _check_stores(got.float().numpy(), np.asarray(want).astype(np.float32),
                  got32, want32, tdt, exact=False)
    # a contracted residual may move a pixel across a cell in the
    # interpreted kernel (``test_torch_deform.py``)
    assert (np.abs(got32 - want32) < 1e-3).mean() > 0.995


def test_store_types_and_their_entry_points():
    assert STORE_SYMBOLS == {torch.float32: "f32", torch.bfloat16: "store_bf16",
                             torch.float16: "store_f16"}
    frame, z = torch.zeros(64, 64), torch.zeros(49)
    kw = dict(frame_shape=(64, 64), wind_size=16, overlap=8)
    for dt in STORE_SYMBOLS:
        assert shift_windows(frame, z, z, out_dtype=dt, **kw).dtype == dt
        assert shift_windows(frame, z, z, out_dtype=dt, interp="bicubic", **kw).dtype == dt
        assert def_windows(frame, z, z, z, z, z, z, out_dtype=dt, **kw).dtype == dt
    for bad in (torch.float64, torch.int32, torch.uint8):
        with pytest.raises(ValueError, match="out_dtype"):
            shift_windows(frame, z, z, out_dtype=bad, **kw)
        with pytest.raises(ValueError, match="out_dtype"):
            def_windows(frame, z, z, z, z, z, z, out_dtype=bad, **kw)
    # the variants store float32 only, as the TPU wrapper's do
    for variant in ("bf16", "lanephases", "mxu", "phases"):
        with pytest.raises(ValueError, match="rolls"):
            shift_windows(frame, z, z, out_dtype=torch.bfloat16, variant=variant, **kw)


# ---------------------------------------------------------------- fused pass

FS = (128, 112)
FN = ((FS[0] - W) // (W - O) + 1) * ((FS[1] - W) // (W - O) + 1)


def _fused_inputs(grey):
    fa, fb = particle_pair(FS, (3.3, -2.1), seed=11)
    if grey == "float":  # grey levels that bfloat16 rounds
        fa, fb = fa * 0.731, fb * 0.731
    rng = np.random.default_rng(11)
    maps = [rng.uniform(-0.5, 0.5, FN).astype(np.float32) + d
            for d in (-1.65, 1.05, 1.65, -1.05)]  # about -+u/2
    return fa.astype(np.float32), fb.astype(np.float32), maps


def test_fused_mxu_extraction_is_the_rolls_one_on_8bit_frames():
    fa, fb, maps = _fused_inputs("8-bit")
    kw = dict(frame_shape=FS, wind_size=W, overlap=O)
    args = [torch.from_numpy(a) for a in (fa, fb, *maps)]
    rolls = fused_piv_pass(*args, **kw)
    mxu = fused_piv_pass(*args, extract_mode="mxu", **kw)
    assert torch.equal(rolls[0], mxu[0]) and torch.equal(rolls[1], mxu[1])
    assert torch.equal(rolls[2], mxu[2])


def test_fused_mxu_extraction_matches_the_jax_one_on_float_frames():
    """On frames that bfloat16 rounds, ``"mxu"`` is the JAX function's
    ``"mxu"`` within ``test_torch_fused.py``'s kernel tolerance (equal
    masks, RMS < 1e-4 px on valid windows) and differs from ``"rolls"``."""
    fa, fb, maps = _fused_inputs("float")
    kw = dict(frame_shape=FS, wind_size=W, overlap=O)
    u, v, inval = fused_piv_pass(*(torch.from_numpy(a) for a in (fa, fb, *maps)),
                                 extract_mode="mxu", **kw)
    ju, jv, ji = jax_fused_piv_pass(*(jnp.asarray(a) for a in (fa, fb, *maps)),
                                    extract_mode="mxu", interpret=True, **kw)
    np.testing.assert_array_equal(inval.numpy(), np.asarray(ji))
    ok = ~inval.numpy()
    assert ok.mean() > 0.9
    d = np.concatenate([(u.numpy() - np.asarray(ju))[ok], (v.numpy() - np.asarray(jv))[ok]])
    assert np.sqrt(np.mean(d ** 2)) < 1e-4
    ru, _, _ = fused_piv_pass(*(torch.from_numpy(a) for a in (fa, fb, *maps)), **kw)
    assert not torch.equal(ru, u)


@pytest.mark.parametrize("stub", ["extract", "extracta", "extractsep", "extractnc",
                                  "corr", "store"])
def test_fused_stubs_raise_naming_the_port_attribution(stub):
    fa, fb, maps = _fused_inputs("8-bit")
    with pytest.raises(ValueError, match="corrfit_anatomy_cuda.py anatomy"):
        fused_piv_pass(*(torch.from_numpy(a) for a in (fa, fb, *maps)),
                       frame_shape=FS, wind_size=W, overlap=O, stub=stub)


def test_fused_rejects_an_unknown_extract_mode():
    fa, fb, maps = _fused_inputs("8-bit")
    with pytest.raises(ValueError, match="extract_mode"):
        fused_piv_pass(*(torch.from_numpy(a) for a in (fa, fb, *maps)),
                       frame_shape=FS, wind_size=W, overlap=O, extract_mode="gather")
