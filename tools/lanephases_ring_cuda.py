#!/usr/bin/env python3
"""The "lanephases" window shift as a ring of shared-memory stages fed by
the copy engine (``tools/lanephases_ring.cu``) at several depths and block
sizes, beside the package's ``csrc/shift_windows_lanephases.cu``
(``warp_bilinear.cuh``'s body on the float32 frame) at several load
depths, on one card.

    python3 tools/lanephases_ring_cuda.py

Each copy is a temporary copy of ``torchpiv_tpu_torch/kernels/csrc`` with
one source edited:

* ``ring D<d> warps<n>``: ``lanephases_ring.cu`` in place of
  ``shift_windows_lanephases.cu``, ``d`` stages a warp and ``n`` warps a
  block (its budget of shared memory raised to what a block may have, so
  that every pair stands as asked, or as near as fits), a tile row a bulk
  copy (``cp.async.bulk``) completing on the stage's ``mbarrier``;
* ``ring cp.async D<d> warps<n>``: the same with each tile copied in
  16-byte ``cp.async`` pieces by the group's lanes, every lane's pieces
  completing on the stage's barrier (``cp.async.mbarrier.arrive.noinc``);
* ``f32 body rows<r>``: ``shift_windows_lanephases.cu`` as committed but
  for ``r`` tile rows loaded ahead for one column a lane.

Every copy is built with ``-Xptxas -v``, all at once, by the package's own
``kernels/_build.py``, and timed at the 4 MP path's pass-2 shape: 2048²
frames of 8-bit grey levels, a batch of 4, 32 px windows at 16 px overlap
(16129 a frame), on shifts uniform in ±24 px from a seed (past the ±16 px
clamp) and on smooth maps (one offset and a slow gradient, like a CWS
pass 2), CUDA events over 20 launches.  Every copy must equal the plain
version bit for bit.  The package's sources are not touched.

Prints the card's name and power limit first, then one line a copy: ms on
the random and the smooth maps, the registers and spill bytes that
``ptxas`` reports for the one-column instance, and for a ring its plan
(shared memory a block, blocks an SM).  Exits with 1 without a card.
``tma_ring_steps`` replays the ring on the CPU (tests/test_torch_lanephases.py).
"""
from __future__ import annotations

import ctypes
import importlib.util
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

import torch

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS.parent))

from torchpiv_tpu_torch.kernels import _build  # noqa: E402
from torchpiv_tpu_torch.kernels.shift import launch_variant  # noqa: E402
from torchpiv_tpu_torch.ops.shifts import (ShiftOperands, _check_writes,  # noqa: E402
                                           _warp_store, blend_reference_variant,
                                           shift_operands, warp_lanes)

_spec = importlib.util.spec_from_file_location("shift_anatomy_cuda",
                                               TOOLS / "shift_anatomy_cuda.py")
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

FRAME, BATCH, W, O = (2048, 2048), 4, 32, 16
NAME = "shift_windows_lanephases"
RING_SOURCE = TOOLS / "lanephases_ring.cu"
DEPTHS, WARPS = (2, 3, 4, 6), (4, 8)
BODY_ROWS = (6, 7, 8)
SMOOTH_SLOPE = 0.002  # px/px, as chip_smoke.py's smooth maps

# lanephases_ring.cu: warps a block and stages a warp's ring at most, the
# shared memory a block aims at and the most a block may have on an H100
# (bytes)
RING_WARPS, RING_DEPTH = 8, 2
RING_SMEM_BUDGET, RING_SMEM_MAX = 100 * 1024, 232448


def ring_plan(w: int) -> dict:
    """The ring's plan for window size ``w`` (``plan_for`` in
    ``lanephases_ring.cu``): the lane map
    ``G``, ``K``, ``P`` of ``warp_lanes``; a window's tile in a slot of
    ``w + 1`` rows of ``box_w = round_up(w + 4, 4)`` floats (a row copy
    starts up to 3 columns before the tile); an item of ``P`` windows a
    stage; ``warps`` warps a block of ``depth`` stages each, while they fit
    the budget, then fewer warps, fewer stages, and one warp of what a
    block holds; ``smem`` the dynamic shared memory a block."""
    G, K = warp_lanes(w, 1)
    P = 32 // G
    box_w = -(-(w + 4) // 4) * 4
    slot = (w + 1) * box_w
    stage = P * slot * 4
    warps, depth = RING_WARPS, RING_DEPTH
    while warps > 1 and warps * depth * stage > RING_SMEM_BUDGET:
        warps >>= 1
    while depth > 2 and warps * depth * stage > RING_SMEM_BUDGET:
        depth -= 1
    if warps * depth * stage > RING_SMEM_BUDGET:
        depth = min(RING_DEPTH, RING_SMEM_MAX // stage)
    return dict(G=G, K=K, P=P, box_w=box_w, slot_floats=slot, warps=warps,
                depth=depth, smem=warps * depth * stage)


def tma_ring_steps(ops: ShiftOperands, wind_size: int, resident_warps: int = 8,
                   _lookahead: Optional[int] = None,
                   _last_column: Optional[int] = None) -> torch.Tensor:
    """The bilinear windows by the steps of ``lanephases_ring.cu``, with
    tensor ops.  The launcher's
    grid: ``min(items, resident_warps)`` warps rounded up to whole blocks of
    the plan's warps, each walking a run of consecutive items (``P``
    windows of one grid row) of the flat ``[B, n_rows, items a row]``
    order.  A warp's ring: the first ``depth`` items' tiles asked for into
    stages ``0..depth-1``; item ``k`` waits on stage ``k % depth``'s phase
    ``k // depth`` (raises unless exactly that phase's copies, of item
    ``k``, have completed there); after its blend the stage takes item
    ``k + depth``.  A tile: ``w + 1`` row copies from the window's clamped
    origin ``(ty, tx)``, each from column ``x0 = tx & ~3`` for
    ``round_up(tx - x0 + w + 1, 4)`` floats of the frame ``[B, Hp, Wp]``
    (zeros past ``Wp``: the pitch's pad) into a slot row of ``box_w``.
    Lane ``c`` of group ``p`` reads slot columns ``s + j`` and ``s + j + 1``,
    ``s = tx - x0``, ``j = c + G * q < w``, of every row (raises if a tile
    column reaches ``w + 1`` or a read leaves the copied span), blends them
    in ``blend_corners``' order and stores row by row; raises unless every
    output element is written exactly once.  ``_lookahead`` (the item a
    stage takes after item ``k``, less ``k``) and ``_last_column`` (the
    last ``j`` a lane reads) exist for the tests that show the model
    catches a wrong ring or a read past the tile.  A model of the kernel's
    index arithmetic for the CPU tests."""
    w = wind_size
    T1 = w + 1
    pl = ring_plan(w)
    G, K, P, box_w, D = pl["G"], pl["K"], pl["P"], pl["box_w"], pl["depth"]
    ahead = D if _lookahead is None else _lookahead
    last_j = w - 1 if _last_column is None else _last_column
    frame = ops.frame
    B, Hp, Wp = frame.shape
    n_rows, n_cols = ops.n_rows, ops.n_cols
    per_row = -(-n_cols // P)
    n_items = B * n_rows * per_row
    blocks = -(-min(n_items, resident_warps) // pl["warps"])
    NW = blocks * pl["warps"]
    run = -(-n_items // NW)
    first = torch.arange(NW) * run
    count = (torch.clamp(first + run, max=n_items) - first).clamp(min=0)

    lane = torch.arange(32)
    c, p = lane & (G - 1), lane >> (G.bit_length() - 1)

    def windows(f):  # [NW] items -> per-lane grid position [NW, 32]
        row, ic = f // per_row, f % per_row
        b, r = (row // n_rows)[:, None], (row % n_rows)[:, None]
        col = ic[:, None] * P + p
        b = b.clamp(max=B - 1)  # a warp past its run computes, copies nothing
        win = (b * n_rows + r) * n_cols + col.clamp(max=n_cols - 1)
        dx = ops.dx.reshape(-1)[win]
        tx = (col * ops.step + ops.off + dx).clamp(0, Wp - T1)
        return b.expand(-1, 32), r.expand(-1, 32), col, win, col < n_cols, tx

    ring = torch.full((NW, D, P, T1, box_w), float("nan"))
    span = torch.zeros(NW, D, P, dtype=torch.int64)  # floats a row copy
    issued = torch.zeros(NW, D, dtype=torch.int64)
    holds = torch.full((NW, D), -1, dtype=torch.int64)
    rows_ar, cols_ar = torch.arange(T1), torch.arange(box_w)
    flat = frame.reshape(-1)

    def issue(k: int) -> None:
        go = k < count
        if not bool(go.any()):
            return
        s = k % D
        b, r, col, win, live, tx = windows(first + k)
        ty = (r * ops.step + ops.off + ops.dy.reshape(-1)[win]).clamp(0, Hp - T1)
        x0 = tx & ~3
        n = (tx - x0 + T1 + 3) // 4 * 4
        yy = ty[..., None, None] + rows_ar[:, None]  # [NW, 32, T1, box_w]
        xx = x0[..., None, None] + cols_ar
        copied = xx < (x0 + n)[..., None, None]
        if bool((xx[copied.expand(xx.shape)] >= -(-Wp // 4) * 4).any()):
            raise RuntimeError("tma_ring_steps: a row copy passes the frame's pitch")
        idx = b[..., None, None] * (Hp * Wp) + yy * Wp + xx.clamp(max=Wp - 1)
        tile = torch.where(copied & (xx < Wp), flat[idx], torch.zeros(()))
        tile = torch.where(copied, tile, torch.full((), float("nan")))
        leader = (c == 0)[None, :] & live & go[:, None]  # a group's tile
        g_idx, l_idx = leader.nonzero(as_tuple=True)
        ring[g_idx, s, p[l_idx]] = tile[g_idx, l_idx]
        span[g_idx, s, p[l_idx]] = n[g_idx, l_idx]
        issued[go, s] += 1
        holds[go, s] = (first + k)[go]

    for k in range(min(D, run)):
        issue(k)
    out = torch.zeros(B, n_rows * n_cols, w, w)
    writes = torch.zeros(out.numel(), dtype=torch.int64)
    j = c[:, None] + G * torch.arange(K)  # [32, K]
    if last_j + 1 > w:
        raise RuntimeError(f"tma_ring_steps: a lane reads tile column {last_j + 1}, "
                           f"past the tile's last column {w}")
    reads = j <= last_j
    jj = j.clamp(max=last_j)
    g_ar = torch.arange(NW)[:, None]
    for k in range(run):
        go = k < count
        s = k % D
        want = first + k
        ok = (issued[:, s] == k // D + 1) & (holds[:, s] == want)
        if not bool(ok[go].all()):
            raise RuntimeError(f"tma_ring_steps: item {k} read from stage {s} "
                               f"before its phase {k // D} completed with its tile")
        _, _, col, win, live, tx = windows(want)
        sh = (tx & 3)[..., None]  # [NW, 32, 1]
        cj = sh + jj[None]  # [NW, 32, K] slot columns
        used = (go[:, None] & live)[..., None] & reads[None]
        if bool((cj + 1 >= span[:, s][g_ar, p[None, :]][..., None])[used].any()):
            raise RuntimeError("tma_ring_steps: a lane reads past its row copy")
        tile = ring[:, s][g_ar, p[None, :]]  # [NW, 32, T1, box_w]
        tile = tile[:, :, None].expand(-1, -1, K, -1, -1)
        cj = cj[..., None, None].expand(-1, -1, -1, T1, 1)
        zero = torch.zeros(())
        v = torch.where(reads[None, :, :, None], torch.gather(tile, 4, cj)[..., 0], zero)
        vr = torch.where(reads[None, :, :, None], torch.gather(tile, 4, cj + 1)[..., 0],
                         zero)
        fy = ops.fy.reshape(-1)[win][..., None, None]
        fx = ops.fx.reshape(-1)[win][..., None, None]
        gx, gy = 1.0 - fx, 1.0 - fy
        t11, t21, t12, t22 = v[..., :w], vr[..., :w], v[..., 1:], vr[..., 1:]
        acc = t11 * (gx * gy)
        acc = acc + t21 * (fx * gy)
        acc = acc + t12 * (gx * fy)
        acc = acc + t22 * (fx * fy)
        val = torch.where((fy == 0.0) | (fx == 0.0), t11, acc)  # [NW, 32, K, w]
        store = (go[:, None] & live)[..., None, None] & (j < w)[None, :, :, None]
        i = torch.arange(w)
        idx = (win[..., None, None] * w + i) * w + j[None, :, :, None]
        _warp_store(out, writes, val, idx, store.expand(val.shape))
        if k + ahead < run:
            issue(k + ahead)
    _check_writes("tma_ring_steps", writes)
    return out



def _edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{old!r} occurs {text.count(old)} times")
    return text.replace(old, new)


def ring_source(depth: int = RING_DEPTH, warps: int = RING_WARPS) -> str:
    """``lanephases_ring.cu`` with ``depth`` stages a warp and ``warps``
    warps a block; other than committed, its budget what a block may have."""
    text = RING_SOURCE.read_text()
    if (depth, warps) == (RING_DEPTH, RING_WARPS):
        return text
    text = _edit(text, f"constexpr int kWarps = {RING_WARPS};",
                 f"constexpr int kWarps = {warps};")
    text = _edit(text, f"constexpr int kDepth = {RING_DEPTH};",
                 f"constexpr int kDepth = {depth};")
    return _edit(text, "constexpr size_t kSmemBudget = 100 * 1024;",
                 f"constexpr size_t kSmemBudget = 232448 - {warps * 64};")


BULK_ROWS = """    if (c == 0 && win.live) bar_expect(bar, (uint32_t)(T1 * len * 4));
    __syncwarp();
    if (lane == 0) bar_arrive(bar);
    if (win.live) {
      const float* src = frame + ((int64_t)win.b * Hp + ty) * pitch + x0;
      const uint32_t dst = ring_addr + 4u * (uint32_t)(s * stage_floats + p * slot_floats);
      for (int row = c; row < T1; row += G)
        bulk_copy(dst + 4u * (uint32_t)(row * box_w), src + (int64_t)row * pitch,
                  (uint32_t)(len * 4), bar);
    }
"""
PIECES = """    if (win.live) {
      const float* src = frame + ((int64_t)win.b * Hp + ty) * pitch + x0;
      const uint32_t dst = ring_addr + 4u * (uint32_t)(s * stage_floats + p * slot_floats);
      const int n4 = len >> 2;
      for (int i = c; i < T1 * n4; i += G) {
        const int row = i / n4, q = i - row * n4;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(
                         dst + 4u * (uint32_t)(row * box_w + 4 * q)),
                     "l"(src + (int64_t)row * pitch + 4 * q)
                     : "memory");
      }
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(bar)
                 : "memory");
"""


def pieces_source(depth: int, warps: int) -> str:
    """``ring_source`` with each tile copied in 16-byte ``cp.async`` pieces
    by the group's lanes (through L1, not the copy engine), every lane's
    pieces completing on the stage's barrier (32 arrivals a phase)."""
    text = _edit(ring_source(depth, warps), BULK_ROWS, PIECES)
    return _edit(text, "bar_init(bar0 + 8 * s, 1);", "bar_init(bar0 + 8 * s, 32);")


def body_source(rows: int) -> str:
    """``shift_windows_lanephases.cu`` as committed, ``rows`` tile rows
    ahead for one column a lane."""
    text = (_build.CSRC / f"{NAME}.cu").read_text()
    return re.sub(r"constexpr int rows_ahead\(\) \{ return K == 1 \? \d+ : 4; \}",
                  f"constexpr int rows_ahead() {{ return K == 1 ? {rows} : 4; }}", text)


def edited_copy(text: str, tag: str) -> Path:
    """A temporary copy of the package's sources whose
    ``shift_windows_lanephases.cu`` is ``text``."""
    copy = Path(tempfile.mkdtemp(prefix=f"csrc_{tag}_"))
    for f in _build.CSRC.iterdir():
        shutil.copy(f, copy / f.name)
    (copy / f"{NAME}.cu").write_text(text)
    return copy


def one_column_summary(log: str) -> dict:
    """``ptxas_summary`` of the one-column instance (``kernel<1>``)."""
    for part in log.split("Compiling entry function")[1:]:
        if "_kernelILi1EE" in part.splitlines()[0]:
            return base.ptxas_summary(part)
    raise RuntimeError("ptxas reported no one-column instance")


def build(copies: dict) -> dict:
    """``{tag: copy}`` built, one ``nvcc`` each, all started together;
    ``{tag: (copy, ptxas summary)}``."""
    started = {}
    for tag, copy in copies.items():
        with base.pointed_at(copy):
            _build._target(NAME).unlink(missing_ok=True)  # always report
            started[tag] = _build._start(NAME)
    out = {}
    for tag, copy in copies.items():
        with base.pointed_at(copy):
            log = _build._finish(NAME, started[tag])
        out[tag] = copy, one_column_summary(log)
    return out


def card_plan(w: int) -> dict:
    """The built ring's plan (its ``_plan`` entry): warps, depth, box_w,
    slot_floats, smem (as ``ring_plan``) and blocks an SM."""
    fn = _build.function(NAME, f"{NAME}_plan", [ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * 6)()
    _build.check_launch(NAME, fn(w, out))
    return dict(zip(("warps", "depth", "box_w", "slot_floats", "smem",
                     "blocks_per_sm"), out))


def ring_ms(ops: ShiftOperands, w: int, plain: torch.Tensor) -> float:
    """Build the committed ring, hold it bit for bit against ``plain`` on
    ``ops`` and return its ms a launch (CUDA events over 20 launches)."""
    copy, _ = build({"ring": edited_copy(ring_source(), "ring")})["ring"]
    try:
        with base.pointed_at(copy):
            out = launch_variant(ops, w, "lanephases")
            torch.cuda.synchronize()
            if not torch.equal(out, plain):
                raise RuntimeError("lanephases_ring.cu is not the plain version")
            del out
            return base.cuda_ms(lambda: launch_variant(ops, w, "lanephases"))
    finally:
        shutil.rmtree(copy)


def maps(n_rows: int, n_cols: int, device) -> dict:
    """``{"random": (vx, vy), "smooth": (vx, vy)}`` of ``[BATCH, N]``."""
    g = torch.Generator().manual_seed(0)
    n = n_rows * n_cols
    random = tuple((torch.rand(BATCH, n, generator=g) * 48 - 24) for _ in range(2))
    pos = torch.arange(n_cols, dtype=torch.float32) * (W - O)
    pos = pos - pos.mean()
    row, col = pos[:n_rows, None], pos[None, :]
    smooth = (3.3 + SMOOTH_SLOPE * (col + row), -2.1 + SMOOTH_SLOPE * (row - col))
    smooth = tuple(v.reshape(1, -1).expand(BATCH, -1).contiguous() for v in smooth)
    return {k: tuple(t.to(device) for t in v)
            for k, v in (("random", random), ("smooth", smooth))}


def measure(frames: torch.Tensor) -> list:
    """Build and time every ring and body copy; one dict each."""
    side = (FRAME[0] - W) // (W - O) + 1
    kw = dict(frame_shape=FRAME, wind_size=W, overlap=O)
    cases = {k: shift_operands(frames, vx, vy, **kw)
             for k, (vx, vy) in maps(side, side, frames.device).items()}
    plain = {k: blend_reference_variant(ops, W, "lanephases") for k, ops in cases.items()}
    copies = {}
    for d in DEPTHS:
        for n in WARPS:
            copies[f"ring D{d} warps{n}"] = edited_copy(ring_source(d, n), f"d{d}w{n}")
            copies[f"ring cp.async D{d} warps{n}"] = edited_copy(pieces_source(d, n),
                                                                  f"p{d}w{n}")
    for r in BODY_ROWS:
        copies[f"f32 body rows{r}"] = edited_copy(body_source(r), f"f32_{r}")
    rows = []
    for tag, (copy, ptxas) in build(copies).items():
        with base.pointed_at(copy):
            plan = card_plan(W) if tag.startswith("ring") else {}
            ms = {}
            for case, ops in cases.items():
                out = launch_variant(ops, W, "lanephases")
                torch.cuda.synchronize()
                if not torch.equal(out, plain[case]):
                    raise RuntimeError(f"{tag} {case}: not the plain version")
                del out
                ms[case] = base.cuda_ms(lambda: launch_variant(ops, W, "lanephases"))
        shutil.rmtree(copy)
        rows.append({"copy": tag, "ms": ms["random"], "smooth_ms": ms["smooth"],
                     **ptxas, **plan})
        print(f"{tag}: {ms['random']:.4f} ms random, {ms['smooth']:.4f} ms smooth, "
              f"{ptxas['registers']} registers, spills {ptxas['spill_stores']} B stored"
              f" / {ptxas['spill_loads']} B loaded"
              + (f", {plan['depth']} stages of {plan['warps']} warps, {plan['smem']} B "
                 f"shared a block, {plan['blocks_per_sm']} blocks an SM" if plan else "")
              + " (bit-equal)", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("lanephases_ring_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    g = torch.Generator().manual_seed(1)
    frames = torch.randint(0, 256, (BATCH, *FRAME), generator=g).float().cuda()
    measure(frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
