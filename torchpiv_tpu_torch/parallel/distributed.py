"""Multi-host (multi-process) campaign support (counterpart of
``torchpiv_tpu/parallel/distributed.py``; ``pair_block``, ``parse_shard``
and ``merge_checkpoints`` are copies).

PIV pairs are independent, so the natural multi-host decomposition is
pure data parallelism with ZERO runtime communication: each process runs
the engine over its own contiguous block of the pair list and persists
its streaming-statistics state (``utils.checkpoint``); the states merge
exactly afterwards (``EnsembleAccumulator.merge``, the Chan parallel
Welford combination).  Per-pair results never cross processes: a
4,000-pair campaign moves ~32 GB of frames but only kilobytes of
statistics state, so the only cross-process traffic worth having is the
final state merge, which reads the shards' state files.

``initialize_distributed`` joins a ``torch.distributed`` process group
(NCCL for CUDA processes, gloo otherwise) for callers that want
collectives; the campaign itself needs none.  Within one process,
``ShardedPIV`` (``parallel.sharded``) splits the pair batch and the window
grid over the local devices.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..stats.ensemble import EnsembleAccumulator


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join a ``torch.distributed`` process group for a multi-process run
    and return ``(rank, world_size)``.

    Arguments fall back to the ``TPIV_COORDINATOR`` (``host:port``) /
    ``TPIV_NUM_PROCESSES`` / ``TPIV_PROCESS_ID`` environment variables; with
    none set (or a single process) this is a no-op returning ``(0, 1)``.
    Otherwise ``init_process_group`` meets the others at
    ``tcp://<coordinator>``.  ``TPIV_COORDINATOR=auto`` leaves everything to
    the launcher (``init_method="env://"``, which reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``, as ``torchrun`` sets
    them), the counterpart of JAX's autodetection.  The backend is
    ``"nccl"`` when the process uses CUDA and ``"gloo"`` otherwise.  A
    process that is already in a group returns its rank and size.
    """
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "TPIV_COORDINATOR")
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("TPIV_NUM_PROCESSES", 0) or 0)
    process_id = process_id if process_id is not None else int(
        os.environ.get("TPIV_PROCESS_ID", 0) or 0)
    auto = coordinator_address == "auto"
    if not auto and (coordinator_address is None or num_processes <= 1):
        return 0, 1
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if auto:
        dist.init_process_group(backend=backend, init_method="env://")
    else:
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def pair_block(
    n_pairs: int, shard_index: int, num_shards: int
) -> Tuple[int, int]:
    """Contiguous block of the (natural-sorted) pair list owned by one
    shard: ``(skip_pairs, max_pairs)``.  Blocks are contiguous (disk
    locality for sequential readers) and sizes differ by at most one.
    """
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard index {shard_index} not in [0, {num_shards})")
    base, extra = divmod(n_pairs, num_shards)
    start = shard_index * base + min(shard_index, extra)
    count = base + (1 if shard_index < extra else 0)
    return start, count


def parse_shard(spec: str) -> Tuple[int, int]:
    """Parse an ``I/N`` shard spec (e.g. ``"0/4"``)."""
    try:
        i, n = (int(t) for t in spec.split("/"))
    except ValueError:
        raise ValueError(f"bad shard spec {spec!r}: expected I/N, e.g. 0/4")
    if n < 1 or not 0 <= i < n:
        raise ValueError(f"bad shard spec {spec!r}: need 0 <= I < N")
    return i, n


def merge_checkpoints(
    paths: Sequence[str],
    allow_partial: bool = False,
) -> Tuple[EnsembleAccumulator, int, np.ndarray, np.ndarray]:
    """Merge shard statistics states (``utils.checkpoint`` files) into one
    accumulator: ``(acc, total_pairs_done, x, y)``.  Exact up to fp
    rounding vs a single sequential pass over all pairs.

    A state not marked complete (an interrupted shard's resume
    checkpoint) is REFUSED unless ``allow_partial=True`` — merging it
    would silently under-count the campaign."""
    from ..utils.checkpoint import checkpoint_is_complete, load_checkpoint

    acc = EnsembleAccumulator()
    total = 0
    x = y = None
    for p in paths:
        state = load_checkpoint(p)
        if state is None:
            # missing OR unreadable (load_checkpoint warns + returns None):
            # a merge must refuse loudly either way — silently dropping a
            # shard would under-count the campaign
            raise FileNotFoundError(f"{p}: shard state missing or unreadable")
        if not allow_partial and not checkpoint_is_complete(p):
            raise ValueError(
                f"{p}: shard state is not marked complete (interrupted "
                "run?) — finish the shard, or pass allow_partial=True / "
                "--allow-partial to merge it anyway")
        a, done, xs, ys = state
        if x is None:
            x, y = xs, ys
        elif x.shape != xs.shape or not (
                np.allclose(x, xs) and np.allclose(y, ys)):
            raise ValueError(
                f"{p}: grid differs from the first shard's — states from "
                "different analysis configs cannot merge")
        acc.merge(a)
        total += done
    if acc.n == 0:
        raise ValueError("no accumulated fields in any shard state")
    return acc, total, x, y
