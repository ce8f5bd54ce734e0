"""Sharded multipass PIV over a mesh (counterpart of
``torchpiv_tpu/parallel/sharded.py``): pair-batch data parallelism and
window-row model parallelism.

* **pairs axis** — the batch of image pairs splits across mesh axis
  ``pairs``; pairs are independent, so each pair shard runs its device's
  engine replica (``MultipassPIV.forward``, fused modes included) on its
  slice of the batch.
* **windows axis** — within one pair, the window grid's *rows* split
  across mesh axis ``windows``.  Window extraction, correlation and peak
  fit are per window; the only cross-window coupling is the spline
  predictor upsample between passes, which needs the full coarse field:
  each pass gathers the shards' tiny ``[B, rloc, C]`` blocks to the devices
  that need them.  Frames are replicated on every device of a pair shard.

Any window-row count works for any axis size: each shard computes a clamped
contiguous block (``_block_layout``), and the static permutation ``pos``
rebuilds the exact field after the gather — duplicated tail rows are
recomputed, never wrong.  A window shard runs the engine's own passes on
its block of window rows (``MultipassPIV.first_pass``/``_refine_pass`` with
``rows=``): pass 1 on the frame band that holds the block, the predictor
from the block's rows of the upsample matrix, and the hand-written shift
and deformation kernels on the block (``row_start``/``n_rows_local``), or,
where the engine takes the JAX engine's XLA paths (``use_pallas="off"``,
windows beyond the kernels' limits, bicubic CWS with a shift variant: the
same rule as the unsharded engine and the JAX ``ShardedPIV``), those paths
on the block's window origins.  As
in the JAX ``ShardedPIV`` the window split runs the unfused correlation and
peak fit whatever ``fused`` says
(``peakfit="pallas"`` still runs the peak-fit kernel on each shard's
windows), and the post-pass field operations (velocity limits, global
sigma test, median filter, second-peak fallback, fused infill) run on the
gathered full field.

Nothing inside a pass waits for the host: the gathers are device-to-device
copies, concatenation and an index on the device.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.multipass import MultipassPIV
from ..utils.device import check_no_tf32
from .mesh import Mesh


def _block_layout(R: int, n_shards: int):
    """Clamped contiguous block per shard + static gather-reconstruction map.

    Shard ``s`` computes rows ``origin(s) .. origin(s)+rloc-1`` with
    ``origin(s) = min(s*rloc, R-rloc)``; ``pos`` maps global row -> position
    in the concatenated ``[n_shards*rloc]`` gather.
    """
    rloc = -(-R // n_shards)
    rloc = min(rloc, R)
    origins = [min(s * rloc, R - rloc) for s in range(n_shards)]
    pos = np.empty(R, dtype=np.int32)
    for s in reversed(range(n_shards)):
        for i in range(rloc):
            r = origins[s] + i
            pos[r] = s * rloc + i
    return rloc, np.array(origins, dtype=np.int32), pos


def _move(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``; asynchronous where the target is a CUDA device."""
    return t.to(dev, non_blocking=dev.type == "cuda")


class ShardedPIV:
    """Sharded multipass PIV over a mesh.

    Args:
      engine: a built ``MultipassPIV``; every other device of the mesh gets
        a copy of it (its buffers moved there), and shards on one device
        share that device's replica.
      mesh: a ``parallel.mesh.Mesh`` with a ``pair_axis`` and optionally a
        ``window_axis``; other axes replicate (their first index runs).

    ``__call__(batch_a, batch_b)``: ``[B, H, W]`` batches (B divisible by
    the pairs-axis size; on any device, pinned host memory for asynchronous
    placement) -> ``(u, v, invalid)`` of shape ``[B, R, C]`` on the mesh's
    first device; ``packed`` gives one ``[B, 3, R, C]`` float32 tensor.
    """

    def __init__(self, engine: MultipassPIV, mesh: Mesh,
                 pair_axis: str = "pairs",
                 window_axis: Optional[str] = "windows"):
        if pair_axis not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no axis {pair_axis!r}")
        self.engine = engine
        self.mesh = mesh
        self.pair_axis = pair_axis
        self.window_axis = window_axis if window_axis in mesh.axis_names else None
        self.n_pair_shards = mesh.shape[pair_axis]
        self.nw = mesh.shape[self.window_axis] if self.window_axis else 1
        # Per-pass block layouts for the windows axis.
        self.layouts = [_block_layout(fs[0], self.nw) for fs in engine.field_shapes]
        names = list(mesh.axis_names)
        order = [names.index(pair_axis)]
        if self.window_axis:
            order.append(names.index(self.window_axis))
        rest = [i for i in range(len(names)) if i not in order]
        grid = np.transpose(mesh.devices, order + rest)
        grid = grid.reshape(*grid.shape[:len(order)], -1)[..., 0]
        # devices[i, j]: the device of pair shard i, window shard j
        self.devices = grid if self.window_axis else grid[:, None]
        self.out_device = mesh.device_list[0]
        self.replicas: Dict[torch.device, MultipassPIV] = {}
        for dev in dict.fromkeys(self.devices.flat):
            self.replicas[dev] = (engine if dev == engine.device
                                  else copy.deepcopy(engine).to(dev))
        self._pos: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    # ---- public ----------------------------------------------------------
    def __call__(self, batch_a: torch.Tensor, batch_b: torch.Tensor):
        parts = self._run(batch_a, batch_b)
        u, v, inval = (torch.cat([_move(p[k], self.out_device) for p in parts])
                       for k in range(3))
        return u, v, inval

    def packed(self, batch_a: torch.Tensor, batch_b: torch.Tensor) -> torch.Tensor:
        """Like ``__call__`` but ONE packed ``[B, 3, R, C]`` float32 tensor
        (``u``, ``v``, invalid as 0/1) on the mesh's first device: one copy a
        pair shard, and one device-to-host copy for the caller (the
        counterpart of ``jit_packed``)."""
        parts = self._run(batch_a, batch_b)
        return torch.cat([_move(torch.stack([u, v, inval.to(u.dtype)], dim=1),
                                self.out_device) for u, v, inval in parts])

    # ---- shards ----------------------------------------------------------
    @torch.no_grad()
    def _run(self, batch_a: torch.Tensor, batch_b: torch.Tensor) -> List[tuple]:
        """Per pair shard ``(u, v, invalid bool)`` ``[B_local, R, C]``: on the
        shard's device (pair split) or on the mesh's first device (window
        split)."""
        H, W = self.engine.config.frame_shape
        if batch_a.dim() != 3 or tuple(batch_a.shape[1:]) != (H, W) or \
                batch_b.shape != batch_a.shape:
            raise ValueError(f"batches {tuple(batch_a.shape)}/{tuple(batch_b.shape)} "
                             f"are not [B, {H}, {W}]")
        B = batch_a.shape[0]
        if B % self.n_pair_shards:
            raise ValueError(f"batch of {B} pairs does not divide the "
                             f"{self.n_pair_shards} pair shards")
        Bl = B // self.n_pair_shards
        slices = [(batch_a[i * Bl:(i + 1) * Bl], batch_b[i * Bl:(i + 1) * Bl])
                  for i in range(self.n_pair_shards)]
        if not self.window_axis:
            out = []
            for i, (a, b) in enumerate(slices):
                dev = self.devices[i, 0]
                u, v, inval = self.replicas[dev](_move(a, dev), _move(b, dev))
                if inval is None:
                    inval = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
                out.append((u, v, inval))
            return out
        for dev in self.replicas:
            check_no_tf32(dev)
        return self._window_split(slices)

    def _frames(self, i: int, a: torch.Tensor, b: torch.Tensor):
        """Pair shard ``i``'s frames on each of its devices, float32 with the
        excluded pixels zeroed: ``{device: (frame_a, frame_b)}``."""
        frames = {}
        for dev in dict.fromkeys(self.devices[i]):
            eng = self.replicas[dev]
            frames[dev] = tuple(eng._masked_frame(_move(f, dev).to(torch.float32))
                                for f in (a, b))
        return frames

    def _window_split(self, slices) -> List[tuple]:
        eng = self.engine
        last = len(eng.schedule) - 1
        want = eng.config.second_peak_fallback
        frames = [self._frames(i, a, b) for i, (a, b) in enumerate(slices)]
        # blocks[i][j]: pass output (u, v, invalid or None, *candidates) of
        # window shard j of pair shard i, [B_local, rloc, C] each
        blocks = []
        for i in range(len(slices)):
            blocks.append([self.replicas[dev].first_pass(
                *frames[i][dev], want_second=want and last == 0,
                rows=self._rows(0, j)) for j, dev in enumerate(self.devices[i])])
        for p in range(1, last + 1):
            for i in range(len(slices)):
                full = {dev: self._gather_full(blocks[i], p - 1, dev)
                        for dev in frames[i]}
                blocks[i] = [self.replicas[dev]._refine_pass(
                    p, *frames[i][dev], *full[dev][0],
                    want_second=want and p == last, rows=self._rows(p, j))
                    for j, dev in enumerate(self.devices[i])]
        # the post-pass field operations on the gathered full field
        out_eng = self.replicas[self.out_device]
        out = []
        for i in range(len(slices)):
            (u, v, inval), cand = self._gather_full(blocks[i], last, self.out_device)
            u, v, inval = out_eng.post_pass(u, v, inval, cand)
            if inval is None:
                inval = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
            out.append((u, v, inval))
        return out

    def _rows(self, p: int, j: int) -> Tuple[int, int]:
        """Window shard ``j``'s block of pass-``p`` window rows ``(org, n)``."""
        rloc, origins, _ = self.layouts[p]
        return int(origins[j]), rloc

    def _gather_full(self, blocks: List[tuple], p: int, dev: torch.device):
        """The window shards' pass-``p`` outputs ``(u, v, invalid or None,
        *candidates)`` on their ``[B_local, rloc, C]`` blocks, copied to
        ``dev``, concatenated and reordered into the full ``[B_local, R, C]``
        fields: ``((u, v, invalid or None), candidates (u, v) or None)``."""
        key = (p, dev)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(self.layouts[p][2].astype(np.int64)).to(dev)
        u, v, inval, *cand = blocks[0]
        # one copy a shard: u, v, invalid as 0/1 and the candidates stacked
        parts = [torch.stack([b[0], b[1]]
                             + ([] if inval is None else [b[2].to(u.dtype)])
                             + ([] if not cand else list(b[3])), dim=1)
                 for b in blocks]
        gathered = torch.cat([_move(t, dev) for t in parts], dim=2)
        full = gathered.index_select(2, self._pos[key]).unbind(1)
        fields = (full[0], full[1], None if inval is None else full[2] >= 0.5)
        return fields, (tuple(full[-2:]) if cand else None)
