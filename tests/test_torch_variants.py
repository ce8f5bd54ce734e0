"""The four bilinear shift variants (``variant="bf16" | "lanephases" | "mxu"
| "phases"``): the port's plain versions against the TPU kernels they
replace (``shift_windows_pallas(variant=...)`` in interpret mode), the
bfloat16 rounding of the frame, the wrapper's refusals and its CPU path.
The CUDA kernels themselves are held against their plain versions on a card
in ``test_torch_cuda.py``.

Tolerances: integer shifts are copies and must match bit for bit;
fractional shifts may differ by 1e-4 of a grey level, because XLA's CPU
backend may contract the multiply-adds of the blend (the JAX package holds
its variants to its own ``rolls`` kernel with the same 1e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchpiv_tpu.kernels.shift_pallas import shift_windows_pallas
from torchpiv_tpu_torch.kernels import KERNELS
from torchpiv_tpu_torch.kernels import shift as shift_module
from torchpiv_tpu_torch.kernels.shift import (BF16_FRAME_VARIANTS, shift_windows,
                                              variant_frame)
from torchpiv_tpu_torch.ops.shifts import (BF16_VARIANTS, VARIANTS,
                                           ShiftOperands,
                                           blend_reference_variant,
                                           gather_tiles, mxu_tile_steps,
                                           shift_operands,
                                           shift_windows_reference,
                                           warp_window_steps)

NEW = [v for v in VARIANTS if v != "rolls"]


def _case(shape, w, o, kind, seed, values="uint8"):
    rng = np.random.default_rng(seed)
    H, W = shape
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    if values == "uint8":  # exact in bfloat16
        frame = rng.integers(0, 256, shape).astype(np.float32)
    else:
        frame = rng.uniform(0, 255, shape).astype(np.float32)
    reach = 1.5 * w  # past the +-S = w/2 clamp
    vx = rng.uniform(-reach, reach, n).astype(np.float32)
    vy = rng.uniform(-reach, reach, n).astype(np.float32)
    if kind == "integer":
        vx, vy = np.round(vx), np.round(vy)
    elif kind == "mixed":  # integer in one axis: the floor corner
        vx = np.round(vx)
    return frame, vx, vy


def _pallas(frame, vx, vy, **kw):
    return np.asarray(shift_windows_pallas(
        jnp.asarray(frame), jnp.asarray(vx), jnp.asarray(vy), interpret=True, **kw))


def _plain(frame, vx, vy, **kw):
    return shift_windows_reference(
        torch.from_numpy(frame), torch.from_numpy(vx), torch.from_numpy(vy), **kw).numpy()


@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed"])
@pytest.mark.parametrize("variant", NEW)
def test_plain_version_matches_pallas_variant(variant, kind):
    shape, w, o = (64, 96), 16, 8
    frame, vx, vy = _case(shape, w, o, kind, seed=11)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, variant=variant)
    want = _pallas(frame, vx, vy, **kw)
    got = _plain(frame, vx, vy, **kw)
    assert got.shape == want.shape
    if kind == "fractional":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, want)
    # 8-bit grey levels are exact in bfloat16: every variant is "rolls"
    np.testing.assert_array_equal(
        got, _plain(frame, vx, vy, **dict(kw, variant="rolls")))


@pytest.mark.parametrize("options", [dict(flat_wrap=False), dict(max_shift=8)],
                         ids=["no_flat_wrap", "max_shift_8"])
@pytest.mark.parametrize("variant", NEW)
def test_plain_version_options_match_pallas_variant(variant, options):
    shape, w, o = (128, 128), 32, 16
    frame, vx, vy = _case(shape, w, o, "integer", seed=12)
    kw = dict(frame_shape=shape, wind_size=w, overlap=o, variant=variant, **options)
    np.testing.assert_array_equal(_plain(frame, vx, vy, **kw),
                                  _pallas(frame, vx, vy, **kw))


@pytest.mark.parametrize("variant", NEW)
def test_float_frame_pins_the_bfloat16_rounding(variant):
    """A frame whose values are not exact in bfloat16: the bfloat16 variants
    equal ``rolls`` on the rounded frame (and the TPU kernel, bit for bit on
    integer shifts), ``lanephases`` equals ``rolls`` on the frame itself."""
    shape, w, o = (64, 96), 16, 8
    frame, vx, vy = _case(shape, w, o, "integer", seed=13, values="float")
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    got = _plain(frame, vx, vy, variant=variant, **kw)
    np.testing.assert_array_equal(got, _pallas(frame, vx, vy, variant=variant, **kw))
    rolls = _plain(frame, vx, vy, **kw)
    if variant in BF16_VARIANTS:
        rounded = torch.from_numpy(frame).to(torch.bfloat16).float().numpy()
        assert not np.array_equal(rounded, frame)
        assert not np.array_equal(got, rolls)
        # rounding commutes with the flat-wrap pad, which only copies pixels
        np.testing.assert_array_equal(got, _plain(rounded, vx, vy, **kw))
        assert np.abs(got - rolls).max() <= 0.5  # half a bfloat16 step below 256
    else:
        np.testing.assert_array_equal(got, rolls)


@pytest.mark.parametrize("variant", NEW)
def test_wrapper_takes_plain_version_on_cpu(variant):
    shape, w, o = (64, 96), 16, 8
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    cases = [_case(shape, w, o, "fractional", seed=s, values="float") for s in (1, 2)]
    frames = torch.from_numpy(np.stack([c[0] for c in cases]))
    vx = torch.from_numpy(np.stack([c[1] for c in cases]))
    vy = torch.from_numpy(np.stack([c[2] for c in cases]))
    before = [k.launches for k in KERNELS]
    batched = shift_windows(frames, vx, vy, variant=variant, **kw)
    named = getattr(shift_module, f"shift_windows_{variant}")(frames, vx, vy, **kw)
    assert [k.launches for k in KERNELS] == before  # no kernel on the CPU
    assert torch.equal(batched, named)
    assert batched.shape == (2, vx.shape[1], w, w) and batched.dtype == torch.float32
    for b in range(2):
        single = shift_windows(frames[b], vx[b], vy[b], variant=variant, **kw)
        assert torch.equal(single, batched[b])
        assert torch.equal(single, shift_windows_reference(
            frames[b], vx[b], vy[b], variant=variant, **kw))


@pytest.mark.parametrize("bad", [
    dict(interp="bicubic"), dict(packed=True), dict(out_dtype=torch.bfloat16)],
    ids=["bicubic", "packed", "out_dtype"])
@pytest.mark.parametrize("variant", NEW)
def test_wrapper_refuses_what_the_pallas_wrapper_refuses(variant, bad):
    kw = dict(frame_shape=(64, 64), wind_size=16, overlap=8, variant=variant)
    frame, maps = torch.zeros(64, 64), torch.zeros(49)
    jbad = dict(bad)
    if "out_dtype" in jbad:
        jbad["out_dtype"] = jnp.bfloat16
    with pytest.raises(ValueError):
        shift_windows_pallas(jnp.zeros((64, 64)), jnp.zeros(49), jnp.zeros(49),
                             interpret=True, **kw, **jbad)
    with pytest.raises(ValueError):
        shift_windows(frame, maps, maps, **kw, **bad)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant"):
        shift_windows(torch.zeros(64, 64), torch.zeros(49), torch.zeros(49),
                      frame_shape=(64, 64), wind_size=16, overlap=8, variant="rols")
    with pytest.raises(ValueError, match="bicubic"):
        shift_windows_reference(torch.zeros(64, 64), torch.zeros(49), torch.zeros(49),
                                frame_shape=(64, 64), wind_size=16, overlap=8,
                                variant="bf16", interp="bicubic")


@pytest.mark.parametrize("variant", NEW)
def test_variant_frame_layout(variant):
    """What the kernels' loads need of the frame the wrapper hands them:
    for ``"bf16"`` and ``"lanephases"`` the padded float32 frame itself, no
    copy (their kernels read it a coalesced row at a time; the first
    rounds each sample as it loads it); else bfloat16, a row pitch in whole
    16-byte pieces with room past the last tile, zeros in the pad and the
    frame itself untouched."""
    shape, w, o = (64, 91), 16, 8  # an odd padded width
    n = ((64 - w) // (w - o) + 1) * ((91 - w) // (w - o) + 1)
    frame = torch.from_numpy(np.random.default_rng(3).uniform(0, 255, shape)
                             .astype(np.float32))[None]
    z = torch.zeros(1, n)
    ops = shift_operands(frame, z, z, frame_shape=shape, wind_size=w, overlap=o)
    Wp = ops.frame.shape[-1]
    got = variant_frame(ops, variant)
    if variant not in BF16_FRAME_VARIANTS:
        assert got.dtype == torch.float32 and got.shape == ops.frame.shape
        assert got.data_ptr() == ops.frame.data_ptr() and got.is_contiguous()
        assert got.stride() == ops.frame.stride()
        return
    assert got.dtype == torch.bfloat16
    assert got.shape[-1] % 8 == 0 and got.shape[-1] >= Wp + 2
    assert torch.equal(got[..., :Wp], ops.frame.to(torch.bfloat16))
    assert got.is_contiguous() and not got[..., Wp:].any()


def _round_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Float32 rounded to bfloat16 and widened back by the bits, as the
    ``"bf16"`` kernel's ``__float2bfloat16_rn`` does for finite samples:
    round to nearest, ties to the even upper half."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("kind", ["integer", "fractional", "mixed"])
def test_rounding_as_loaded_equals_the_bf16_plain_version(kind):
    """The ``"bf16"`` kernel reads the float32 frame and rounds each sample
    as it loads it; the warp steps on samples rounded so equal
    ``blend_reference_variant(..., "bf16")``, which rounds the padded frame
    first, on a frame of exact bfloat16 half-way points (both ways of the
    tie), large values, negative zeros and values just off a tie."""
    shape, w, o = (64, 96), 16, 8
    frame, vx, vy = _case(shape, w, o, kind, seed=21, values="float")
    rng = np.random.default_rng(22)
    one = np.float32(1.0)
    special = np.array([
        one + np.float32(2 ** -8), one + np.float32(3 * 2 ** -8),  # ties: down, up
        np.float32(255.5), np.float32(254.5), np.float32(-128.25),
        np.float32(1e30), np.float32(-3.0e29), np.float32(65504.0 + 128.0),
        np.float32(-0.0), np.float32(0.0),
        np.nextafter(one + np.float32(2 ** -8), np.float32(2)),  # past a tie: up
        np.nextafter(one + np.float32(2 ** -8), np.float32(0))], np.float32)
    frame.flat[rng.choice(frame.size, frame.size // 3, replace=False)] = \
        special[rng.integers(0, len(special), frame.size // 3)]
    bits = _round_bf16_bits(frame)
    torch_rounded = torch.from_numpy(frame).to(torch.bfloat16).float().numpy()
    assert np.array_equal(bits.view(np.uint32), torch_rounded.view(np.uint32))
    assert np.signbit(bits[frame == 0]).tolist() == np.signbit(frame[frame == 0]).tolist()
    kw = dict(frame_shape=shape, wind_size=w, overlap=o)
    ops = shift_operands(*(torch.from_numpy(a)[None] for a in (frame, vx, vy)), **kw)
    as_loaded = ops._replace(frame=torch.from_numpy(
        _round_bf16_bits(ops.frame.numpy())))
    want = blend_reference_variant(ops, w, "bf16")
    assert torch.equal(warp_window_steps(as_loaded, w), want)
    assert torch.equal(shift_windows(*(torch.from_numpy(a) for a in (frame, vx, vy)),
                                     variant="bf16", **kw), want[0])
    assert not torch.equal(want, blend_reference_variant(ops, w, "rolls"))


# tile origins with every remainder modulo 8, and at the frame's far edges
MXU_ORIGINS = [(r, (3 * r + 1) % 8) for r in range(8)] + [
    (8 + c, c) for c in range(8)] + [(0, 0), (-1, -1), (-1, 5), (2, -1)]


@pytest.mark.parametrize("origin", MXU_ORIGINS, ids=lambda o: f"{o[0]}_{o[1]}")
def test_mxu_chained_banded_products_equal_the_gather(origin):
    """``(Wy @ block) @ Wx`` in bfloat16, by 16-row strips and with the two
    banded slices of each product as the kernel sums them, is the gather of
    the tile, exactly; ``-1`` puts the tile against the frame's last row or
    column, where the aligned block reaches beyond the frame."""
    Hp, Wp, w = 75, 83, 32
    T = w + 1
    frame = torch.from_numpy(np.random.default_rng(5).uniform(0, 255, (1, Hp, Wp))
                             .astype(np.float32))
    z = torch.zeros(1, 1)
    ops = ShiftOperands(frame, z.int(), z.int(), z, z, 0, 1, 1, 1)
    bf16 = variant_frame(ops, "mxu")[0]
    ty = origin[0] if origin[0] >= 0 else Hp - T
    tx = origin[1] if origin[1] >= 0 else Wp - T
    got = mxu_tile_steps(bf16, ty, tx, T)
    want = gather_tiles(bf16.float()[None, :, :Wp].contiguous(),
                        torch.tensor([[ty]]), torch.tensor([[tx]]), T)[0, 0]
    assert got.shape == (T, T) and torch.equal(got, want)
    assert torch.equal(got, got.to(torch.bfloat16).float())  # one term a sum


@pytest.mark.parametrize("w", [4, 8, 16, 64])
def test_mxu_step_model_window_sizes(w):
    """Other tile sizes: one strip (w 4, 8), a strip of padding only (w 16)
    and five strips (w 64), through the blend of the plain version."""
    shape = (3 * w + 5, 4 * w + 3)
    frame, vx, vy = _case(shape, w, w // 2, "fractional", seed=w, values="float")
    args = [torch.from_numpy(a)[None] for a in (frame, vx, vy)]
    ops = shift_operands(*args, frame_shape=shape, wind_size=w, overlap=w // 2)
    want = blend_reference_variant(ops, w, "mxu")
    bf16 = variant_frame(ops, "mxu")[0]
    Hp, Wp = ops.frame.shape[-2:]
    T = w + 1
    n = torch.arange(ops.n_rows * ops.n_cols)
    ty = ((n // ops.n_cols) * ops.step + ops.off + ops.dy[0]).clamp(0, Hp - T)
    tx = ((n % ops.n_cols) * ops.step + ops.off + ops.dx[0]).clamp(0, Wp - T)
    tiles = torch.stack([mxu_tile_steps(bf16, int(y), int(x), T)
                         for y, x in zip(ty, tx)])
    # the plain version's blend on the model's tiles
    tiled = torch.zeros(1, len(n) * T, T)
    tiled[0] = tiles.reshape(-1, T)
    grid = ops._replace(frame=tiled, dy=torch.zeros_like(ops.dy),
                        dx=torch.zeros_like(ops.dx), off=0, n_rows=len(n),
                        n_cols=1, step=T)
    assert torch.equal(blend_reference_variant(grid, w, "rolls"), want)
