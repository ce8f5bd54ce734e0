"""Per-window CWS/DWS window shift: the plain PyTorch versions of the shift
kernels (``kernels/shift.py``).

Bilinear: exactly what the TPU kernel ``_shift_kernel``
(``torchpiv_tpu/kernels/shift_pallas.py``) computes, which is what the TPU
main path runs:

* shifts clip to ``+-S`` with ``S = max_shift or max(w // 2, 1)``;
* ``dy, dx = floor(v)`` and ``fy, fx = v - floor(v)``, one pair per window;
* each window reads a ``(w+1)**2`` tile at its origin plus ``(dy, dx)``,
  clamped into the (padded) frame;
* the tile's four corner slices blend with per-window scalar weights, in the
  kernel's term order; a window whose shift is an integer in either axis
  takes the floor corner unchanged.

Bicubic (``interp="bicubic"``, the TPU kernel ``_shift_kernel_bicubic``):
the Keys cubic convolution (a = -0.5) over a ``(w+4)**2`` tile at the
origin plus ``(dy - 1, dx - 1)``, with per-window scalar weights
``cubic_weights(fy)``, ``cubic_weights(fx)``; the sum runs over ``kx``
inside ``ky`` as the kernel's does.  Integer shifts give the weights
``(0, 1, 0, 0)`` exactly, so they reproduce the integer copy without a
special case.  The flat-wrap pad is ``S + 2``.

Variants (``variant=``, bilinear only; the TPU kernels of
``torchpiv_tpu/experimental/shift_variants.py``): ``"bf16"``, ``"mxu"`` and
``"phases"`` read the padded frame rounded to bfloat16 (round to nearest
even, after the flat-wrap pad, as the TPU wrapper casts it) and blend in
float32; ``"lanephases"`` reads the float32 frame.  On a frame whose values
are exact in bfloat16 (8-bit grey levels) every variant equals ``"rolls"``.

With ``flat_wrap`` the frame is padded by ``flat_wrap_pad`` so edge windows
reproduce the reference's flat-index clamped addressing.

The JAX engine's XLA paths (``cws_shift``, ``bicubic_cws_shift`` and
``dws_shift`` at the end of this module, copies of
``torchpiv_tpu/ops/shifts.py:39-194``) have other semantics, the
reference's (``PIVbackend.py:147-216``): per-pixel coordinates and weights,
no clamp to ``max_shift``, indices clamped on the *flattened* frame to
``[0, H*W - 1]`` (an out-of-frame sample wraps into the previous or next
row), and a pixel whose coordinate is an integer in either axis takes the
floor corner (bilinear).  ``use_pallas="off"`` selects them, and so do
windows beyond the kernels' limits (``MultipassPIV``).

Row blocks (``row_start``, ``n_rows_local``; the TPU kernels' ``row0``
scalar): the operands then cover window rows ``row_start .. row_start +
n_rows_local - 1`` of the grid, the maps and the output ``[B, n_rows_local *
n_cols]`` and ``[B, n_rows_local * n_cols, w, w]``, and a window's origin row
is ``(row_start + r) * step + off``.  The frame stays the whole frame, so a
tile clamps to the full frame as it does in a full launch: each block equals
the same rows of the full call bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .geometry import get_field_shape
from .packing import packed_width


def flat_wrap_pad(frame: torch.Tensor, P: int) -> torch.Tensor:
    """Pad ``[..., H, W]`` frames by ``P`` so that 2-D sampling of the result
    reproduces the reference's flat-index-clamped addressing of the original:
    out-of-row columns wrap into the adjacent row, and the overhangs before
    the first and after the last pixel clamp to those pixels."""
    H, W = frame.shape[-2:]
    lead = frame.shape[:-2]
    first = frame[..., :1, :1]
    last = frame[..., -1:, -1:]
    left = torch.roll(frame[..., W - P:], 1, dims=-2)
    left[..., 0, :] = first[..., 0, :]
    right = torch.roll(frame[..., :P], -1, dims=-2)
    right[..., -1, :] = last[..., 0, :]
    mid = torch.cat([left, frame, right], dim=-1)
    # virtual row -1 with columns >= W wraps forward into row 0's head;
    # deeper rows clamp entirely
    top = first.expand(*lead, P, W + 2 * P).clone()
    top[..., -1, W + P:] = frame[..., 0, :P]
    # virtual row H with columns < 0 wraps back into the last row's tail
    bot = last.expand(*lead, P, W + 2 * P).clone()
    bot[..., 0, :P] = frame[..., -1, W - P:]
    return torch.cat([top, mid, bot], dim=-2)


class ShiftOperands(NamedTuple):
    """What the shift kernel reads: the padded float32 frames ``[B, Hp, Wp]``,
    the per-window integer parts ``dy, dx`` (int32 ``[B, N]``) and fractional
    parts ``fy, fx`` (float32 ``[B, N]``), the window-origin offset into the
    padded frame, and the window grid: ``n_rows`` rows from grid row
    ``row_start`` on (the whole grid with ``row_start = 0``), ``N = n_rows *
    n_cols``."""

    frame: torch.Tensor
    dy: torch.Tensor
    dx: torch.Tensor
    fy: torch.Tensor
    fx: torch.Tensor
    off: int
    n_rows: int
    n_cols: int
    step: int
    row_start: int = 0


def window_grid(frame: torch.Tensor, maps, frame_shape: Tuple[int, int],
                wind_size: int, overlap: int, row_start: int = 0,
                n_rows_local: Optional[int] = None) -> Tuple[int, int]:
    """The ``(n_rows, n_cols)`` window grid, or with a row block its
    ``(n_rows_local, n_cols)``, after checking that the block lies in the
    grid and that the ``[B, H, W]`` frames and the ``[B, N]`` per-window maps
    fit it."""
    n_rows, n_cols = get_field_shape(frame_shape, wind_size, overlap)
    row_start = int(row_start)
    if n_rows_local is None:
        n_rows_local = n_rows - row_start
    if not (0 <= row_start and 1 <= n_rows_local
            and row_start + n_rows_local <= n_rows):
        raise ValueError(f"row block {row_start}..{row_start + n_rows_local - 1} "
                         f"is not inside the {n_rows} window rows")
    n_rows = n_rows_local
    if tuple(frame.shape[-2:]) != tuple(frame_shape):
        raise ValueError(f"frame shape {tuple(frame.shape[-2:])} != {tuple(frame_shape)}")
    want = (frame.shape[0], n_rows * n_cols)
    if any(m.shape != want for m in maps):
        raise ValueError(
            f"per-window maps must be [B, {n_rows * n_cols}] for frames "
            f"{tuple(frame.shape)}")
    return n_rows, n_cols


def split_shift(vel: torch.Tensor, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip a shift map to ``+-S`` and split it into its integer part (int32)
    and fractional part (float32), as the TPU kernels' wrappers do."""
    v = vel.to(torch.float32).clamp(-S, S)
    d = torch.floor(v)
    return d.to(torch.int32).contiguous(), (v - d).contiguous()


def gather_tiles(frame: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor,
                 T: int) -> torch.Tensor:
    """``[B, N, T, T]`` tiles of ``[B, Hp, Wp]`` frames at the ``[B, N]``
    origins ``(ty, tx)``."""
    B, _, Wp = frame.shape
    ar = torch.arange(T, device=frame.device)
    idx = ((ty[..., None] + ar)[..., :, None] * Wp
           + (tx[..., None] + ar)[..., None, :])
    return torch.gather(frame.reshape(B, -1), 1,
                        idx.reshape(B, -1)).reshape(*idx.shape)


def padded_origins(n_rows: int, n_cols: int, step: int, off: int, device,
                   row_start: int = 0):
    """Flat ``[N]`` row and column origins of the windows of grid rows
    ``row_start .. row_start + n_rows - 1`` in a frame padded by ``off``."""
    n = torch.arange(n_rows * n_cols, device=device)
    row0 = (row_start + torch.div(n, n_cols, rounding_mode="floor")) * step + off
    col0 = (n % n_cols) * step + off
    return row0, col0


def shift_operands(
    frame: torch.Tensor,
    vel_x: torch.Tensor,
    vel_y: torch.Tensor,
    *,
    frame_shape: Tuple[int, int],
    wind_size: int,
    overlap: int,
    max_shift: Optional[int] = None,
    flat_wrap: bool = True,
    interp: str = "bilinear",
    row_start: int = 0,
    n_rows_local: Optional[int] = None,
) -> ShiftOperands:
    """Pad the ``[B, H, W]`` frames and split the ``[B, N]`` shifts as the
    TPU kernel's wrapper does (``shift_pallas.py``, clip/floor/frac); with
    a row block the maps cover window rows ``row_start .. row_start +
    n_rows_local - 1`` (``n_rows_local`` defaults to the rest of the
    grid)."""
    if interp not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown interp {interp!r}")
    w = wind_size
    cubic = interp == "bicubic"
    n_rows, n_cols = window_grid(frame, (vel_x, vel_y), frame_shape, w, overlap,
                                 row_start, n_rows_local)
    S = max_shift if max_shift is not None else max(w // 2, 1)
    T = w + (4 if cubic else 1)
    frame = frame.to(torch.float32)
    off = 0
    if flat_wrap:
        off = S + 2 if cubic else S  # the cubic stencil reaches floor-1..floor+2
        frame = flat_wrap_pad(frame, off)
    if frame.shape[-2] < T or frame.shape[-1] < T:
        raise ValueError(f"a {T} px tile does not fit the {tuple(frame.shape[-2:])} frame")
    dy, fy = split_shift(vel_y, S)
    dx, fx = split_shift(vel_x, S)
    return ShiftOperands(frame.contiguous(), dy, dx, fy, fx,
                         off, n_rows, n_cols, w - overlap, int(row_start))


def blend_reference(ops: ShiftOperands, wind_size: int) -> torch.Tensor:
    """The bilinear kernel's arithmetic on ``ShiftOperands`` ->
    ``[B, N, w, w]``."""
    w = wind_size
    T = w + 1
    B, Hp, Wp = ops.frame.shape
    row0, col0 = padded_origins(ops.n_rows, ops.n_cols, ops.step, ops.off,
                                ops.frame.device, ops.row_start)
    ty = (row0 + ops.dy).clamp(0, Hp - T)
    tx = (col0 + ops.dx).clamp(0, Wp - T)
    tile = gather_tiles(ops.frame, ty, tx, T)
    f11 = tile[..., :w, :w]
    f21 = tile[..., :w, 1:]
    f12 = tile[..., 1:, :w]
    f22 = tile[..., 1:, 1:]
    fy = ops.fy[..., None, None]
    fx = ops.fx[..., None, None]
    blend = (
        f11 * ((1.0 - fx) * (1.0 - fy))
        + f21 * (fx * (1.0 - fy))
        + f12 * ((1.0 - fx) * fy)
        + f22 * (fx * fy)
    )
    # integer shift in EITHER axis -> floor corner (reference fallback)
    return torch.where((fy == 0.0) | (fx == 0.0), f11, blend)


WARPS = 8  # warps a block of csrc/shift_windows.cu and csrc/warp_lanes.cuh


def warp_lanes(w: int, reach: int = 1) -> Tuple[int, int]:
    """``(G, K)`` of the lane map for window size ``w`` whose stencil reads
    ``reach`` tile columns past the window (``csrc/shift_windows.cu``,
    ``csrc/warp_lanes.cuh``: 1 bilinear, 3 bicubic): a window a group of
    ``G`` lanes (a power of two, at least ``reach``; ``32 // G`` windows a
    warp), ``K`` tile columns a lane."""
    if w > 32:
        return 32, -(-w // 32)
    return 1 << max(w - 1, reach - 1, 0).bit_length(), 1


class _WarpGrid(NamedTuple):
    """Lane-level index grids ``[n_rows, n_bx, WARPS, 32]`` of a warp-a-window
    kernel and the per-lane window operands ``[B, ...]`` of the same shape."""

    G: int
    K: int
    r: torch.Tensor  # grid row of the block
    col: torch.Tensor  # grid column of the lane's window
    c: torch.Tensor  # the lane's place in its group
    group: torch.Tensor  # the group's first lane
    live: torch.Tensor  # the window exists (a ragged row's last groups only load)
    win: torch.Tensor  # flat window index, clamped into the row
    slot_col: torch.Tensor  # [..., K + 1] tile column of each slot
    ty: torch.Tensor  # tile origin, clamped
    tx: torch.Tensor
    fy: torch.Tensor
    fx: torch.Tensor


def _warp_grid(ops: ShiftOperands, w: int, reach: int, margin: int) -> _WarpGrid:
    """Block ``(bx, r, b)`` of ``WARPS`` warps; lane ``l`` of a warp serves
    the window in grid column ``((bx * WARPS + warp) << (5 - lg)) + (l >>
    lg)`` of row ``r`` (``G = 1 << lg``) as lane ``c = l & (G - 1)`` of its
    group; slot ``k`` holds tile column ``c + G * k``.  The tile of side
    ``w + reach + margin`` (``margin`` the stencil's reach before the
    window: 0 bilinear, 1 bicubic) starts at the window's origin plus its
    integer shift minus ``margin``, clamped into the frame."""
    G, K = warp_lanes(w, reach)
    lg = G.bit_length() - 1
    T = w + reach + margin
    B, Hp, Wp = ops.frame.shape
    n_rows, n_cols = ops.n_rows, ops.n_cols
    n_bx = -(-n_cols // (WARPS * (32 // G)))
    r = torch.arange(n_rows)[:, None, None, None]
    bx = torch.arange(n_bx)[None, :, None, None]
    warp = torch.arange(WARPS)[None, None, :, None]
    lane = torch.arange(32)[None, None, None, :]
    col = ((bx * WARPS + warp) << (5 - lg)) + (lane >> lg)
    c = (lane & (G - 1)).expand(col.shape)
    win = r * n_cols + col.clamp(max=n_cols - 1)
    dy, dx, fy, fx = (m[:, win] for m in (ops.dy, ops.dx, ops.fy, ops.fx))
    ty = ((ops.row_start + r) * ops.step + ops.off + dy - margin).clamp(0, Hp - T)
    tx = (col.clamp(max=n_cols - 1) * ops.step + ops.off + dx - margin).clamp(0, Wp - T)
    return _WarpGrid(G, K, r, col, c, lane & ~(G - 1), col < n_cols, win,
                     c[..., None] + G * torch.arange(K + 1), ty, tx, fy, fx)


def _warp_load_row(ops: ShiftOperands, g: _WarpGrid, i: int, last: int):
    """Tile row ``i`` into every lane's slots ``[B, ..., K + 1]``: the slot's
    column where the row and the column are at most ``last``, else 0."""
    B, _, Wp = ops.frame.shape
    in_tile = (g.slot_col <= last) & (i <= last)
    idx = (g.ty + i)[..., None] * Wp + g.tx[..., None] + g.slot_col.clamp(max=last)
    v = torch.gather(ops.frame.reshape(B, -1), 1, idx.reshape(B, -1)).reshape(idx.shape)
    return torch.where(in_tile, v, torch.zeros((), dtype=v.dtype))


def _warp_right_at(g: _WarpGrid, v: torch.Tensor, d: int) -> torch.Tensor:
    """Column ``j + d`` of each slot's column ``j`` by the kernels' shuffle:
    from the group's lane ``(c + d) & (G - 1)``, every lane ``c < d``
    offering its next slot in place of its own."""
    K = g.K
    offered = torch.where((g.c < d)[..., None], v[..., 1:], v[..., :K])
    src = (g.group + ((g.c + d) & (g.G - 1))).expand(offered.shape[:-1])
    return torch.gather(offered, 4, src[..., None].expand(offered.shape))


def _warp_store(out, writes, val, idx, ok) -> None:
    """Scatter ``val[ok]`` to ``out`` at ``idx[ok]`` and count the writes."""
    idx = idx.expand(val.shape)[ok.expand(val.shape)]
    out.view(-1)[idx] = val[ok.expand(val.shape)]
    writes += torch.bincount(idx, minlength=writes.numel())


def _check_writes(name: str, writes: torch.Tensor) -> None:
    if not bool((writes == 1).all()):
        raise RuntimeError(f"{name}: an output element is written "
                           f"{int(writes.min())}..{int(writes.max())} times")


def warp_window_steps(ops: ShiftOperands, wind_size: int,
                      packed: bool = False) -> torch.Tensor:
    """The bilinear windows by the steps of ``csrc/shift_windows.cu`` and of
    ``csrc/warp_bilinear.cuh``'s body (in ``shift_windows_lanephases.cu``;
    on the frame rounded to bfloat16, in ``shift_windows_phases.cu`` and
    ``shift_windows_bf16.cu``),
    with tensor ops: the lane map of ``_warp_grid`` (reach 1); the warp
    walks the tile rows, each loaded once and carried to the next step as
    the row above; a slot's right neighbour comes from the group's lane
    ``(c + 1) & (G - 1)``, whose lane 0 offers its next slot.  Blended in
    ``blend_corners``' order and scattered to ``[B, N, w, w]`` (``packed``:
    ``[B, n_rows, w, Lp]``, the last window of a row repeated into the
    tail); raises unless every output element is written exactly once.  A
    model of the kernel's index arithmetic for the CPU tests: no path of
    the package calls it."""
    w = wind_size
    g = _warp_grid(ops, w, reach=1, margin=0)
    K = g.K
    B = ops.frame.shape[0]
    n_rows, n_cols = ops.n_rows, ops.n_cols
    gx, gy = 1.0 - g.fx, 1.0 - g.fy
    w11, w21, w12, w22 = gx * gy, g.fx * gy, gx * g.fy, g.fx * g.fy
    copy = (g.fy == 0.0) | (g.fx == 0.0)
    if packed:
        Lp = packed_width(n_cols, w)
        out = torch.zeros(B, n_rows, w, Lp)
        copies = torch.where(g.col == n_cols - 1, Lp // w - n_cols + 1, 1)
    else:
        out = torch.zeros(B, n_rows * n_cols, w, w)
        copies = torch.ones_like(g.col)
    writes = torch.zeros(out.numel(), dtype=torch.int64)
    b_idx = torch.arange(B).reshape(B, 1, 1, 1, 1, 1)
    top = _warp_load_row(ops, g, 0, w)
    top_right = _warp_right_at(g, top, 1)
    for i in range(w):
        below = _warp_load_row(ops, g, i + 1, w)
        below_right = _warp_right_at(g, below, 1)
        t11, t21, t12, t22 = top[..., :K], top_right, below[..., :K], below_right
        e = (Ellipsis, None)
        acc = t11 * w11[e]
        acc = acc + t21 * w21[e]
        acc = acc + t12 * w12[e]
        acc = acc + t22 * w22[e]
        val = torch.where(copy[e], t11, acc)
        j = g.slot_col[..., :K]
        store = (g.live[..., None] & (j < w))
        for q in range(int(copies.max())):
            ok = store & (q < copies)[..., None]
            if packed:
                idx = (((b_idx * n_rows + g.r[..., None]) * w + i) * out.shape[-1]
                       + g.col[..., None] * w + q * w + j)
            else:
                idx = ((b_idx * n_rows * n_cols + g.win[..., None]) * w + i) * w + j
            _warp_store(out, writes, val, idx, ok)
        top, top_right = below, below_right
    _check_writes("warp_window_steps", writes)
    return out


def warp_bicubic_steps(ops: ShiftOperands, wind_size: int) -> torch.Tensor:
    """The bicubic windows by the steps of ``csrc/shift_windows_bicubic.cu``,
    with tensor ops, on ``ShiftOperands`` made with ``interp="bicubic"``:
    the lane map of ``_warp_grid`` with reach 3 (the group's first three
    lanes hold the tile's last columns in their extra slot where the main
    slots do not reach ``w + 2``); the warp walks the ``w + 3`` tile rows
    the stencil reads, each loaded once; columns ``j + 1 .. j + 3`` come by
    three shuffles a slot, past the group's end from the extra or next slot
    that the partner lane offers; the horizontal sum ``h`` of each tile row
    and column is formed once, in the plain version's order, into a ring of
    four rows indexed by the tile row modulo 4; when tile row ``i + 3``
    arrives, output row ``i`` is the vertical sum of the ring's four rows,
    oldest first, scattered to ``[B, N, w, w]``.  Raises unless every output
    element is written exactly once.  A model of the kernel's index
    arithmetic for the CPU tests: no path of the package calls it."""
    w = wind_size
    last = w + 2  # the last tile row and column the stencil reads
    g = _warp_grid(ops, w, reach=3, margin=1)
    K = g.K
    B = ops.frame.shape[0]
    n_win = ops.n_rows * ops.n_cols
    e = (Ellipsis, None)
    wy = [t[e] for t in cubic_weights(g.fy)]
    wx = [t[e] for t in cubic_weights(g.fx)]

    def taps(wt, a, b, c, d):  # (((0 + w0 a) + w1 b) + w2 c) + w3 d
        acc = torch.zeros_like(a) + wt[0] * a
        acc = acc + wt[1] * b
        acc = acc + wt[2] * c
        return acc + wt[3] * d

    out = torch.zeros(B, n_win, w, w)
    writes = torch.zeros(out.numel(), dtype=torch.int64)
    b_idx = torch.arange(B).reshape(B, 1, 1, 1, 1, 1)
    j = g.slot_col[..., :K]
    store = g.live[..., None] & (j < w)
    ring = [None] * 4  # ring[tr & 3]: the horizontal sums of tile row tr
    for tr in range(last + 1):
        v = _warp_load_row(ops, g, tr, last)
        n1, n2, n3 = (_warp_right_at(g, v, d) for d in (1, 2, 3))
        ring[tr & 3] = taps(wx, v[..., :K], n1, n2, n3)
        if tr < 3:
            continue
        i = tr - 3
        val = taps(wy, ring[(tr + 1) & 3], ring[(tr + 2) & 3],
                   ring[(tr + 3) & 3], ring[tr & 3])
        idx = ((b_idx * n_win + g.win[..., None]) * w + i) * w + j
        _warp_store(out, writes, val, idx, store)
    _check_writes("warp_bicubic_steps", writes)
    return out


VARIANTS = ("rolls", "bf16", "lanephases", "mxu", "phases")
BF16_VARIANTS = ("bf16", "mxu", "phases")  # blend the frame rounded to bfloat16


def blend_reference_variant(ops: ShiftOperands, wind_size: int,
                            variant: str = "rolls") -> torch.Tensor:
    """The arithmetic of the bilinear kernel ``variant`` on
    ``ShiftOperands`` -> ``[B, N, w, w]``: ``blend_reference``, for the
    bfloat16 variants on the padded frame rounded to bfloat16."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown shift variant {variant!r}")
    if variant in BF16_VARIANTS:
        rounded = ops.frame.to(torch.bfloat16).to(torch.float32)
        ops = ops._replace(frame=rounded)
    return blend_reference(ops, wind_size)


def mxu_tile_steps(frame: torch.Tensor, ty: int, tx: int, T: int) -> torch.Tensor:
    """The ``T x T`` tile at the clamped origin ``(ty, tx)`` of one bfloat16
    ``[Hp, pitch]`` frame (``pitch`` a multiple of 8) by the steps of the
    ``"mxu"`` kernel (``csrc/shift_windows_mxu.cu``), with tensor ops: the
    ``KP x KP`` block at the origin rounded down to 8, zero beyond the
    frame's rows and pitch; per 16-row strip, ``Wy @ block`` as the sum over
    the two 16-deep slices of block rows that the banded one-hot ``Wy`` can
    select, 16 columns at a time, cast to bfloat16; then times ``Wx``: the
    left 8 of 16 output columns from the chunk's own slice, the right 8
    from it and the first 8 columns of the next.  Products in bfloat16 with
    float32 sums.  A model of the kernel's index arithmetic for the CPU
    tests: no path of the package calls it."""
    Hp, pitch = frame.shape
    Tp = -(-T // 16) * 16
    KP = -(-(T + 7) // 16) * 16
    s_row, s_col = ty % 8, tx % 8
    ty0, tx0 = ty - s_row, tx - s_col
    block = torch.zeros(KP, KP, dtype=torch.bfloat16)
    rows = min(KP, Hp - ty0)
    cols = min(KP, (pitch - tx0) // 8 * 8)  # whole 16-byte pieces
    block[:rows, :cols] = frame[ty0:ty0 + rows, tx0:tx0 + cols]
    block = block.to(torch.float32)
    k = torch.arange(16)

    def one_hot(match):  # [16, 16] selector, exact in bfloat16
        return match.to(torch.float32)

    def strip_slice(i0, col0):  # 16 columns of Wy @ block for the strip
        acc = torch.zeros(16, 16)
        if col0 < KP:
            for s in range(2):
                if i0 + 16 * s < KP:
                    wy = one_hot(k[None, :] == (s_row - 16 * s + k)[:, None])
                    acc = acc + wy @ block[i0 + 16 * s:i0 + 16 * s + 16, col0:col0 + 16]
        return acc.to(torch.bfloat16).to(torch.float32)

    n = torch.arange(8)
    wx_a = one_hot(k[:, None] == (n + s_col)[None, :])
    wx_b = one_hot(k[:, None] == (n + s_col + 8)[None, :])
    wx_c = one_hot(k[:8, None] == (n + s_col - 8)[None, :])
    tile = torch.zeros(Tp, Tp)
    for i0 in range(0, Tp, 16):
        cur = strip_slice(i0, 0)
        for col in range(0, Tp, 16):
            nxt = strip_slice(i0, col + 16)
            tile[i0:i0 + 16, col:col + 8] = cur @ wx_a
            tile[i0:i0 + 16, col + 8:col + 16] = cur @ wx_b + nxt[:, :8] @ wx_c
            cur = nxt
    return tile[:T, :T]

def cubic_weights(t: torch.Tensor):
    """Keys cubic-convolution weights (a = -0.5) of the four taps at
    ``floor - 1 .. floor + 2`` for the fraction ``t``, in the TPU kernel's
    term order (``shift_pallas.py``, ``cubic_weights``)."""
    a = -0.5

    def inner(d):  # |d| <= 1
        return (a + 2) * (d * d * d) - (a + 3) * (d * d) + 1.0

    def outer(d):  # 1 <= |d| < 2
        return a * (d * d * d) - (5 * a) * (d * d) + (8 * a) * d - 4 * a

    return outer(t + 1.0), inner(t), inner(1.0 - t), outer(2.0 - t)


def blend_reference_bicubic(ops: ShiftOperands, wind_size: int) -> torch.Tensor:
    """The bicubic kernel's arithmetic on ``ShiftOperands`` (made with
    ``interp="bicubic"``) -> ``[B, N, w, w]``."""
    w = wind_size
    T = w + 4
    B, Hp, Wp = ops.frame.shape
    row0, col0 = padded_origins(ops.n_rows, ops.n_cols, ops.step, ops.off,
                                ops.frame.device, ops.row_start)
    # tile origin = window origin + floor(shift) - 1 (stencil margin)
    ty = (row0 + ops.dy - 1).clamp(0, Hp - T)
    tx = (col0 + ops.dx - 1).clamp(0, Wp - T)
    tile = gather_tiles(ops.frame, ty, tx, T)
    wy = cubic_weights(ops.fy[..., None, None])
    wx = cubic_weights(ops.fx[..., None, None])
    acc = torch.zeros((*ops.fy.shape, w, w), dtype=torch.float32,
                      device=ops.frame.device)
    for ky in range(4):
        row_acc = torch.zeros_like(acc)
        for kx in range(4):
            row_acc = row_acc + wx[kx] * tile[..., ky:ky + w, kx:kx + w]
        acc = acc + wy[ky] * row_acc
    return acc


def shift_windows_reference(
    frame: torch.Tensor,
    vel_x: torch.Tensor,
    vel_y: torch.Tensor,
    *,
    frame_shape: Tuple[int, int],
    wind_size: int,
    overlap: int,
    max_shift: Optional[int] = None,
    flat_wrap: bool = True,
    interp: str = "bilinear",
    variant: str = "rolls",
    row_start: int = 0,
    n_rows_local: Optional[int] = None,
) -> torch.Tensor:
    """Shifted windows ``[B, N, w, w]`` float32 from ``[B, H, W]`` frames and
    ``[B, N]`` per-window shifts (``[N, w, w]`` from ``[H, W]`` and ``[N]``);
    ``variant`` (bilinear only) is one of ``VARIANTS``; ``row_start`` and
    ``n_rows_local`` select a block of window rows (``shift_operands``)."""
    if variant != "rolls" and interp != "bilinear":
        raise ValueError("bicubic requires the plain 'rolls' variant")
    batched = frame.dim() == 3
    if not batched:
        frame, vel_x, vel_y = frame[None], vel_x[None], vel_y[None]
    ops = shift_operands(frame, vel_x, vel_y, frame_shape=frame_shape,
                         wind_size=wind_size, overlap=overlap,
                         max_shift=max_shift, flat_wrap=flat_wrap, interp=interp,
                         row_start=row_start, n_rows_local=n_rows_local)
    if interp == "bicubic":
        out = blend_reference_bicubic(ops, wind_size)
    else:
        out = blend_reference_variant(ops, wind_size, variant)
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# The JAX engine's XLA resampling paths: torch ops, computed in ``dtype``


def _window_pixel_grids(row0w: torch.Tensor, col0w: torch.Tensor,
                        wind_size: int):
    """Per-pixel int32 (row, col) grids ``[N, w, 1]`` and ``[N, 1, w]`` from
    ``[N]`` window origins."""
    ar = torch.arange(wind_size, dtype=torch.int32, device=row0w.device)
    gy = row0w.to(torch.int32)[:, None, None] + ar[None, :, None]
    gx = col0w.to(torch.int32)[:, None, None] + ar[None, None, :]
    return gy, gx


def _batched(frame, vel_x, vel_y):
    """``[B, H, W]`` frames and shifts that broadcast against ``[B, N, w,
    w]`` (a per-window ``[B, N]`` map gains two unit axes), and whether the
    frames came batched."""
    batched = frame.dim() == 3
    if not batched:
        frame, vel_x, vel_y = frame[None], vel_x[None], vel_y[None]
    if vel_x.dim() == 2:
        vel_x, vel_y = vel_x[..., None, None], vel_y[..., None, None]
    return frame, vel_x, vel_y, batched


def _flat_sampler(frame: torch.Tensor):
    """``take(idx)``: the samples of ``[B, H, W]`` frames at int32 flat
    indices ``[B, ...]``, each clamped to ``[0, H*W - 1]`` within its own
    frame (the reference's addressing)."""
    B, H, W = frame.shape
    numel = H * W
    flat = frame.reshape(-1)
    base = torch.arange(B, dtype=torch.int32, device=frame.device) * numel

    def take(idx):
        idx = idx.clamp(0, numel - 1) + base.view(B, *([1] * (idx.dim() - 1)))
        return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape)

    return take


def cws_shift(frame: torch.Tensor, row0w: torch.Tensor, col0w: torch.Tensor,
              wind_size: int, vel_x: torch.Tensor, vel_y: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Continuous window shift, bilinear with per-pixel weights.

    ``frame``: ``[B, H, W]`` (or ``[H, W]``); ``row0w, col0w``: ``[N]``
    window origins; ``vel_x, vel_y``: ``[B, N]`` per-window or ``[B, N, w,
    w]`` per-pixel shifts in pixels (``[N]``, ``[N, w, w]`` unbatched).
    Returns ``[B, N, w, w]`` in ``dtype``, which the coordinates, samples
    and blend are computed in.  Mirrors reference
    ``biliniar_interpolation_CWS`` (PIVbackend.py:147-194)."""
    frame, vel_x, vel_y, batched = _batched(frame, vel_x, vel_y)
    W = frame.shape[-1]
    take = _flat_sampler(frame)
    gy, gx = _window_pixel_grids(row0w, col0w, wind_size)
    new_y = gy.to(dtype) + vel_y.to(dtype)
    new_x = gx.to(dtype) + vel_x.to(dtype)
    up_x = torch.ceil(new_x).to(torch.int32)
    up_y = torch.ceil(new_y).to(torch.int32)
    down_x = torch.floor(new_x).to(torch.int32)
    down_y = torch.floor(new_y).to(torch.int32)
    # an integer coordinate in either axis: the floor corner
    integer_cell = (up_x - down_x) * (up_y - down_y) == 0

    def sample(y, x):
        return take(y * W + x).to(dtype)

    f11 = sample(down_y, down_x)
    f21 = sample(down_y, up_x)
    f12 = sample(up_y, down_x)
    f22 = sample(up_y, up_x)
    ux, uy = up_x.to(dtype), up_y.to(dtype)
    dx, dy = down_x.to(dtype), down_y.to(dtype)
    f = (f11 * (ux - new_x) * (uy - new_y)
         + f21 * (new_x - dx) * (uy - new_y)
         + f12 * (ux - new_x) * (new_y - dy)
         + f22 * (new_x - dx) * (new_y - dy))
    out = torch.where(integer_cell, f11, f)
    return out if batched else out[0]


def bicubic_cws_shift(frame: torch.Tensor, row0w: torch.Tensor,
                      col0w: torch.Tensor, wind_size: int, vel_x: torch.Tensor,
                      vel_y: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Continuous window shift with Keys bicubic (a = -0.5) per-pixel
    weights: ``cws_shift``'s arguments, addressing and result; the 16 taps
    are summed over ``i`` (columns) inside ``j`` (rows), and integer
    coordinates give the weights ``(0, 1, 0, 0)`` exactly."""
    frame, vel_x, vel_y, batched = _batched(frame, vel_x, vel_y)
    W = frame.shape[-1]
    take = _flat_sampler(frame)
    gy, gx = _window_pixel_grids(row0w, col0w, wind_size)
    new_y = gy.to(dtype) + vel_y.to(dtype)
    new_x = gx.to(dtype) + vel_x.to(dtype)
    fy = torch.floor(new_y)
    fx = torch.floor(new_x)
    wy = cubic_weights(new_y - fy)
    wx = cubic_weights(new_x - fx)
    iy = fy.to(torch.int32)
    ix = fx.to(torch.int32)
    zero = torch.zeros((), dtype=dtype, device=frame.device)
    out = zero
    for j, wyj in enumerate(wy):
        idx_row = (iy + (j - 1)) * W
        acc = zero
        for i, wxi in enumerate(wx):
            acc = acc + wxi * take(idx_row + ix + (i - 1)).to(dtype)
        out = out + wyj * acc
    return out if batched else out[0]


def dws_shift(frame: torch.Tensor, row0w: torch.Tensor, col0w: torch.Tensor,
              wind_size: int, vel_x: torch.Tensor, vel_y: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Discrete window shift: the integer copy of each window at ``[B, N]``
    per-window shifts (truncated to int32), in ``dtype``.  Mirrors reference
    ``interpolation_DWS`` (PIVbackend.py:197-216)."""
    frame, vel_x, vel_y, batched = _batched(frame, vel_x, vel_y)
    W = frame.shape[-1]
    gy, gx = _window_pixel_grids(row0w, col0w, wind_size)
    idx = (gy + vel_y.to(torch.int32)) * W + gx + vel_x.to(torch.int32)
    out = _flat_sampler(frame)(idx).to(dtype)
    return out if batched else out[0]
