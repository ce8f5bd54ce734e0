"""Window-deformation (DEF) resampling: the plain PyTorch version of the DEF
kernel (``kernels/deform.py``) and the operands both read.

It computes exactly what the TPU kernel ``_def_kernel`` behind
``def_windows_pallas`` (``torchpiv_tpu/kernels/def_pallas.py``) computes.
Every window is resampled with a per-PIXEL displacement: the window's centre
shift plus its gradient times the pixel's signed offset from the window
centre.

* centre shifts clip to ``+-S`` with ``S = max_shift or max(w // 2, 1)`` and
  split into ``dy, dx = floor(v)`` and ``fy, fx = v - floor(v)``;
* each window reads a ``T**2`` tile, ``T = w + 2M + 1`` (bilinear) or
  ``w + 2M + 4`` (bicubic), at its origin plus ``(dy, dx)`` minus
  ``BASE = M`` (``M + 1`` bicubic), clamped into the (padded) frame; ``M`` is
  the margin;
* per pixel ``(i, j)`` the residual sample position, relative to the
  bilinear tile origin, is ``ry = ((M + fy) + gyi*ioff) + gyj*joff`` (and
  ``rx`` alike) with ``ioff = i - (w-1)/2``, clipped to
  ``[0, 2M + 1 - 1e-3]``: deformations steeper than about ``2M / w`` px/px
  saturate;
* bilinear: hat weights ``max(0, 1 - |r - k|)`` on the two neighbours; a
  pixel whose ``ry`` OR ``rx`` is an integer takes the floor corner (both
  coordinates are replaced by their floors);
* bicubic: Keys weights (a = -0.5) on the four neighbours
  ``floor(r) .. floor(r) + 3`` of the one-pixel-earlier cubic tile; they
  collapse to ``(0, 1, 0, 0)`` at integers on their own;
* the taps are summed in ascending ``ky``, then ``kx``, each as
  ``(wy * wx) * tile``.  The TPU kernel sums over all ``(2M+2)**2`` or
  ``(2M+4)**2`` static tile shifts, and every term outside these taps is an
  exact zero, so the float32 sums agree.

With ``flat_wrap`` the frame is padded by ``S + M + 1`` (``S + M + 3``
bicubic) so that edge windows reproduce the reference's flat-index clamped
addressing and the tile clamp never binds.

``row_start`` and ``n_rows_local`` select a block of window rows as in
``ops.shifts``: the maps and the output cover just those rows, the frame is
the whole frame, and a window's origin row is ``(row_start + r) * step +
off``.

``def_windows_xla`` is the JAX engine's XLA DEF path instead
(``torchpiv_tpu/models/multipass.py:786-806``): the same per-pixel
displacement built densely, ``vel + d/dx * off[j] + d/dy * off[i]`` with
``off = arange(w) - (w - 1) / 2``, resampled by ``ops.shifts.cws_shift`` or
``bicubic_cws_shift``: no clamp, no saturation, the reference's flat-index
addressing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .shifts import (bicubic_cws_shift, cws_shift, flat_wrap_pad,
                     gather_tiles, padded_origins, split_shift, window_grid)


class DefOperands(NamedTuple):
    """What the DEF kernel reads: the padded float32 frames ``[B, Hp, Wp]``,
    the per-window integer and fractional centre shifts, the four gradient
    maps in the kernel's order (all ``[B, N]``), and the geometry: ``n_rows``
    window rows from grid row ``row_start`` on."""

    frame: torch.Tensor
    dy: torch.Tensor  # int32
    dx: torch.Tensor  # int32
    fy: torch.Tensor
    fx: torch.Tensor
    gyi: torch.Tensor  # dv/dy: row residual per in-window row offset
    gyj: torch.Tensor  # dv/dx
    gxi: torch.Tensor  # du/dy
    gxj: torch.Tensor  # du/dx
    off: int
    n_rows: int
    n_cols: int
    step: int
    margin: int
    cubic: bool
    row_start: int = 0


def def_operands(
    frame: torch.Tensor,
    vel_x: torch.Tensor,
    vel_y: torch.Tensor,
    dudx: torch.Tensor,
    dudy: torch.Tensor,
    dvdx: torch.Tensor,
    dvdy: torch.Tensor,
    *,
    frame_shape: Tuple[int, int],
    wind_size: int,
    overlap: int,
    max_shift: Optional[int] = None,
    margin: int = 2,
    flat_wrap: bool = True,
    interp: str = "bilinear",
    row_start: int = 0,
    n_rows_local: Optional[int] = None,
) -> DefOperands:
    """Pad the ``[B, H, W]`` frames and prepare the ``[B, N]`` maps as the
    TPU kernel's wrapper does (``def_pallas.py``); with a row block the maps
    cover window rows ``row_start .. row_start + n_rows_local - 1``."""
    if interp not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown interp {interp!r}")
    if margin < 1:
        raise ValueError(f"margin must be at least 1, not {margin}")
    w = wind_size
    cubic = interp == "bicubic"
    maps = (vel_x, vel_y, dudx, dudy, dvdx, dvdy)
    n_rows, n_cols = window_grid(frame, maps, frame_shape, w, overlap,
                                 row_start, n_rows_local)
    S = max_shift if max_shift is not None else max(w // 2, 1)
    T = w + 2 * margin + (4 if cubic else 1)
    frame = frame.to(torch.float32)
    off = 0
    if flat_wrap:
        # the extreme tile (last window row, +S shift) stays inside
        off = S + margin + (3 if cubic else 1)
        frame = flat_wrap_pad(frame, off)
    if frame.shape[-2] < T or frame.shape[-1] < T:
        raise ValueError(f"a {T} px tile does not fit the {tuple(frame.shape[-2:])} frame")
    dy, fy = split_shift(vel_y, S)
    dx, fx = split_shift(vel_x, S)

    def f32(m):
        return m.to(torch.float32).contiguous()

    return DefOperands(frame.contiguous(), dy, dx, fy, fx,
                       f32(dvdy), f32(dvdx), f32(dudy), f32(dudx),
                       off, n_rows, n_cols, w - overlap, margin, cubic,
                       int(row_start))


def keys_weight(d: torch.Tensor) -> torch.Tensor:
    """Keys cubic-convolution weight (a = -0.5) at signed distance ``d``, in
    the TPU kernel's term order (``def_pallas.py``, ``keys``)."""
    a = -0.5
    ad = d.abs()
    ad2 = ad * ad
    ad3 = ad * ad * ad
    w_in = (a + 2) * ad3 - (a + 3) * ad2 + 1.0
    w_out = a * ad3 - (5 * a) * ad2 + (8 * a) * ad - 4 * a
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.where(ad <= 1.0, w_in, torch.where(ad < 2.0, w_out, zero))


def def_reference(ops: DefOperands, wind_size: int) -> torch.Tensor:
    """The kernel's arithmetic on ``DefOperands`` -> ``[B, N, w, w]``."""
    w = wind_size
    M = ops.margin
    T = w + 2 * M + (4 if ops.cubic else 1)
    base = M + (1 if ops.cubic else 0)
    n_tap = 4 if ops.cubic else 2
    B, Hp, Wp = ops.frame.shape
    dev = ops.frame.device
    row0, col0 = padded_origins(ops.n_rows, ops.n_cols, ops.step, ops.off, dev,
                                ops.row_start)
    ty = (row0 + ops.dy - base).clamp(0, Hp - T)
    tx = (col0 + ops.dx - base).clamp(0, Wp - T)
    tile = gather_tiles(ops.frame, ty, tx, T).reshape(B, -1, T * T)

    half = (w - 1) / 2.0
    ar = torch.arange(w, device=dev, dtype=torch.float32) - half
    ioff = ar[:, None]
    joff = ar[None, :]

    # float32(2M + 1) - float32(1e-3): keeps floor(r) <= 2M
    hi = (torch.tensor(2 * M + 1, dtype=torch.float32) - 1e-3).item()

    def residual(f, gi, gj):
        r = (M + f)[..., None, None] + gi[..., None, None] * ioff \
            + gj[..., None, None] * joff
        return r.clamp(0.0, hi)

    ry = residual(ops.fy, ops.gyi, ops.gyj)
    rx = residual(ops.fx, ops.gxi, ops.gxj)
    fry = torch.floor(ry)
    frx = torch.floor(rx)
    if not ops.cubic:
        # integer sample coordinate in EITHER axis -> floor corner
        int_cell = (ry == fry) | (rx == frx)
        ry = torch.where(int_cell, fry, ry)
        rx = torch.where(int_cell, frx, rx)
    ky0 = fry.to(torch.int64)
    kx0 = frx.to(torch.int64)
    ai = torch.arange(w, device=dev)[:, None]
    aj = torch.arange(w, device=dev)[None, :]

    def weight(r, k):  # tap k of the tile, as a float
        if ops.cubic:
            return keys_weight(r + 1.0 - k)
        return torch.clamp(1.0 - (r - k).abs(), min=0.0)

    acc = torch.zeros_like(ry)
    for a in range(n_tap):
        ky = ky0 + a
        wy = weight(ry, ky.to(torch.float32))
        for b in range(n_tap):
            kx = kx0 + b
            wx = weight(rx, kx.to(torch.float32))
            idx = (ai + ky) * T + (aj + kx)
            val = torch.gather(tile, 2, idx.reshape(B, -1, w * w)).reshape(idx.shape)
            acc = acc + (wy * wx) * val
    return acc


THREADS = 128  # threads a block of csrc/def_windows.cu, at most
BLOCK_WINDOWS = 8  # windows of a grid row a block walks
STAGES = 2  # its tile buffers


def block_geometry(w: int) -> Tuple[int, int, int]:
    """``(Q, R, threads)`` of ``csrc/def_windows.cu`` for window size ``w``:
    column quads a pixel row, pixel rows a pass, threads a block (whole
    warps)."""
    Q = -(-w // 4)
    R = min(w, THREADS // Q)
    return Q, R, max(32, -(-(Q * R) // 32) * 32)


def keys_tap(d: torch.Tensor, k: int) -> torch.Tensor:
    """``keys_weight`` of tap ``k`` at distance ``d = (r + 1) - (floor(r) +
    k)`` as the kernel evaluates it: the piece the tap's position fixes, the
    inner one ``(1.5|d|^3 - 2.5|d|^2) + 1`` for taps 1 and 2 (``|d| <= 1``),
    the outer one ``((-0.5|d|^3 - -2.5|d|^2) + -4|d|) - -2`` for taps 0 and
    3 (``1 <= |d| <= 2``, where it gives +0 at both ends)."""
    ad = d.abs()
    ad2 = ad * ad
    ad3 = ad2 * ad
    if k in (1, 2):
        return (1.5 * ad3 - 2.5 * ad2) + 1.0
    return ((-0.5 * ad3 - (-2.5) * ad2) + (-4.0) * ad) - (-2.0)


def def_block_steps(ops: DefOperands, wind_size: int) -> torch.Tensor:
    """The deformed windows by the steps of ``csrc/def_windows.cu``, with
    tensor ops: block ``(bx, r, b)`` walks windows ``8 bx .. 8 bx + 7`` of
    grid row ``r``; window ``k``'s clamped tile is staged into buffer
    ``k % STAGES`` (thread ``t`` copies elements ``t + m * threads``, its
    row and column stepped with a carry) before window ``k - STAGES + 1`` is
    computed
    from its own buffer; thread ``t`` computes column quad ``t % Q`` of
    pixel rows ``t // Q + m R`` from the row part ``by + gyi*ioff`` (once a
    row) plus the column part ``gyj*joff`` (once a window), gathers its
    taps from the buffer and weights them with ``keys_tap`` or the hat.  Scattered to ``[B, N, w,
    w]``; raises unless every tile element is staged once and every output
    element written once.  A model of the kernel's index arithmetic for the
    CPU tests: no path of the package calls it."""
    w, M = wind_size, ops.margin
    T = w + 2 * M + (4 if ops.cubic else 1)
    base = M + (1 if ops.cubic else 0)
    B, Hp, Wp = ops.frame.shape
    n_rows, n_cols = ops.n_rows, ops.n_cols
    Q, R, threads = block_geometry(w)
    TP = T | 1  # the buffer's row pitch: odd, against bank conflicts
    n_bx = -(-n_cols // BLOCK_WINDOWS)
    flat = ops.frame.reshape(B, -1)
    bshape = (B, n_rows, n_bx)
    b_idx = torch.arange(B).reshape(B, 1, 1)
    r = torch.arange(n_rows).reshape(1, n_rows, 1)
    bx = torch.arange(n_bx).reshape(1, 1, n_bx)

    # the staging walk: thread t copies tile elements e = t + m * threads,
    # its row and column stepped on by (threads // T, threads % T) with a
    # carry, not divided out of e
    rows, cols, dst = [], [], []
    i, j = torch.arange(threads) // T, torch.arange(threads) % T
    row_step, col_step = threads // T, threads % T
    for m in range(-(-T * T // threads)):
        e = torch.arange(threads) + m * threads
        live = e < T * T
        rows.append(i[live])
        cols.append(j[live])
        dst.append(e[live])
        i, j = i + row_step, j + col_step
        i, j = torch.where(j >= T, i + 1, i), torch.where(j >= T, j - T, j)
    rows, cols, walked = torch.cat(rows), torch.cat(cols), torch.cat(dst)
    staged = torch.bincount(walked, minlength=T * T)
    if not (bool((staged == 1).all()) and torch.equal(rows * T + cols, walked)):
        raise RuntimeError("def_block_steps: the staging misses, repeats or "
                           "misplaces tile elements")
    elem = rows * Wp + cols  # frame offsets
    dst_elem = rows * TP + cols  # buffer offsets, rows TP apart

    def window(k):  # flat window index [B, n_rows, n_bx] of window k, and live
        c = bx * BLOCK_WINDOWS + k
        live = (c < n_cols).expand(bshape)
        wi = (b_idx * n_rows + r) * n_cols + c.clamp(max=n_cols - 1)
        return wi.expand(bshape), c.clamp(max=n_cols - 1), live

    def stage(k, buffers):
        wi, c, _ = window(k)
        dy, dx = ops.dy.reshape(-1)[wi], ops.dx.reshape(-1)[wi]
        ty = ((ops.row_start + r) * ops.step + ops.off + dy - base).clamp(0, Hp - T)
        tx = (c * ops.step + ops.off + dx - base).clamp(0, Wp - T)
        idx = (ty * Wp + tx)[..., None] + elem
        vals = torch.gather(flat, 1, idx.reshape(B, -1)).reshape(*bshape, -1)
        buffers[..., k % STAGES, dst_elem] = vals

    # the thread map: quad q, first row p0, rows p0 + m R
    tid = torch.arange(threads)
    q, p0 = tid % Q, tid // Q
    m = torch.arange(-(-w // R))
    pi = p0[:, None] + R * m[None, :]  # [threads, m]
    pj = 4 * q[:, None] + torch.arange(4)[None, :]  # [threads, 4]
    active = ((p0 < R)[:, None, None] & (pi < w)[:, :, None]
              & (pj < w)[:, None, :])  # [threads, m, 4]
    half = (w - 1) / 2.0
    ioff = pi.to(torch.float32) - half
    joff = pj.to(torch.float32) - half
    hi = (torch.tensor(2 * M + 1, dtype=torch.float32) - 1e-3).item()

    out = torch.zeros(B * n_rows * n_cols * w * w)
    writes = torch.zeros(out.numel(), dtype=torch.int64)
    buffers = torch.zeros(*bshape, STAGES, T * TP)
    for k in range(STAGES - 1):
        stage(k, buffers)
    e3 = (Ellipsis, None, None, None)
    for k in range(BLOCK_WINDOWS):
        if k + STAGES - 1 < BLOCK_WINDOWS:
            stage(k + STAGES - 1, buffers)  # into window k - 1's buffer
        tile = buffers[..., k % STAGES, :]
        wi, _, live = window(k)

        def at(mp):
            return mp.reshape(-1)[wi]

        by = M + at(ops.fy)
        bx_ = M + at(ops.fx)
        col_y = at(ops.gyj)[..., None, None] * joff  # [.., threads, 4]
        col_x = at(ops.gxj)[..., None, None] * joff
        row_y = by[..., None, None] + at(ops.gyi)[..., None, None] * ioff
        row_x = bx_[..., None, None] + at(ops.gxi)[..., None, None] * ioff
        ry = (row_y[..., None] + col_y[..., :, None, :]).clamp(0.0, hi)
        rx = (row_x[..., None] + col_x[..., :, None, :]).clamp(0.0, hi)
        fry, frx = torch.floor(ry), torch.floor(rx)
        if not ops.cubic:
            int_cell = (ry == fry) | (rx == frx)
            ry = torch.where(int_cell, fry, ry)
            rx = torch.where(int_cell, frx, rx)
        ok = active & live[e3]
        corner = ((pi[:, :, None] + fry.to(torch.int64)) * TP
                  + pj[:, None, :] + frx.to(torch.int64))
        corner = torch.where(ok, corner, torch.zeros((), dtype=torch.int64))
        n_tap = 4 if ops.cubic else 2
        if ops.cubic:
            wy = [keys_tap((ry + 1.0) - (fry + a), a) for a in range(n_tap)]
            wx = [keys_tap((rx + 1.0) - (frx + a), a) for a in range(n_tap)]
        else:
            wy = [torch.clamp(1.0 - (ry - (fry + a)).abs(), min=0.0) for a in range(2)]
            wx = [torch.clamp(1.0 - (rx - (frx + a)).abs(), min=0.0) for a in range(2)]
        acc = torch.zeros_like(ry)
        flat_tile = tile.reshape(*bshape, -1)
        for a in range(n_tap):
            for c in range(n_tap):
                idx = corner + a * TP + c
                val = torch.gather(flat_tile, 3, idx.reshape(*bshape, -1)).reshape(idx.shape)
                acc = acc + (wy[a] * wx[c]) * val
        dst = (wi[e3] * w + pi[:, :, None]) * w + pj[:, None, :]
        dst = dst.expand(ok.shape)[ok]
        out[dst] = acc[ok]
        writes += torch.bincount(dst, minlength=writes.numel())
    if not bool((writes == 1).all()):
        raise RuntimeError("def_block_steps: an output element is written "
                           f"{int(writes.min())}..{int(writes.max())} times")
    return out.reshape(B, n_rows * n_cols, w, w)


def def_windows_reference(
    frame: torch.Tensor,
    vel_x: torch.Tensor,
    vel_y: torch.Tensor,
    dudx: torch.Tensor,
    dudy: torch.Tensor,
    dvdx: torch.Tensor,
    dvdy: torch.Tensor,
    **kw,
) -> torch.Tensor:
    """Deformed windows ``[B, N, w, w]`` float32 from ``[B, H, W]`` frames and
    ``[B, N]`` centre shifts and gradients (``[N, w, w]`` from ``[H, W]`` and
    ``[N]``); keywords as ``def_operands``."""
    maps = (vel_x, vel_y, dudx, dudy, dvdx, dvdy)
    batched = frame.dim() == 3
    if not batched:
        frame = frame[None]
        maps = tuple(m[None] for m in maps)
    ops = def_operands(frame, *maps, **kw)
    out = def_reference(ops, kw["wind_size"])
    return out if batched else out[0]


def def_windows_xla(
    frame: torch.Tensor,
    row0w: torch.Tensor,
    col0w: torch.Tensor,
    wind_size: int,
    vel_x: torch.Tensor,
    vel_y: torch.Tensor,
    dudx: torch.Tensor,
    dudy: torch.Tensor,
    dvdx: torch.Tensor,
    dvdy: torch.Tensor,
    interp: str = "bilinear",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Deformed windows ``[B, N, w, w]`` in ``dtype`` through the JAX
    engine's XLA path, from ``[B, H, W]`` frames, ``[N]`` window origins and
    ``[B, N]`` centre shifts and gradients (``[N, w, w]`` from ``[H, W]`` and
    ``[N]``).  The dense shifts are formed in ``dtype``; negated maps give
    the negated shifts exactly, as the JAX engine's ``-du_d``."""
    if interp not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown interp {interp!r}")
    off = (torch.arange(wind_size, dtype=dtype, device=frame.device)
           - (wind_size - 1) / 2.0)

    def dense(center, gx, gy):
        return (center.to(dtype)[..., None, None]
                + gx.to(dtype)[..., None, None] * off
                + gy.to(dtype)[..., None, None] * off[:, None])

    resample = bicubic_cws_shift if interp == "bicubic" else cws_shift
    return resample(frame, row0w, col0w, wind_size, dense(vel_x, dudx, dudy),
                    dense(vel_y, dvdx, dvdy), dtype)
