"""Run checkpointing: resume long pair-stream analyses by pair index (a
copy of ``torchpiv_tpu/utils/checkpoint.py`` over the port's
``EnsembleAccumulator``, in the same file format, so that a state saved by
either package loads in the other).

The reference has no checkpoint/resume — a stopped run is rerun from scratch
(SURVEY §5); its closest analog is the per-pair incremental saves.  Here the
runner persists the streaming statistics state (Welford moments) plus the
number of pairs already processed; pairs are consumed in deterministic
(natural-sorted) order, so "resume" = restore moments and skip that many
pairs.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from ..stats.ensemble import EnsembleAccumulator


def save_checkpoint(
    path: str, acc: EnsembleAccumulator, done: int,
    x: np.ndarray, y: np.ndarray, complete: bool = False,
) -> None:
    """Atomically persist the accumulator state, progress counter and grid.

    ``complete=True`` marks a FINISHED shard state (every pair of the
    shard's block processed) — ``parallel.merge_checkpoints`` refuses
    in-progress resume checkpoints by default, so a crashed shard cannot
    silently under-count a merged campaign."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".npz")
    try:
        # write through the open handle so np.savez cannot append a second
        # ".npz" suffix (which would leave the mkstemp file behind)
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                done=done,
                complete=bool(complete),
                n=acc.n,
                x=x,
                y=y,
                mu=acc._mu if acc.n else np.zeros(0),
                mv=acc._mv if acc.n else np.zeros(0),
                muu=acc._muu if acc.n else np.zeros(0),
                mvv=acc._mvv if acc.n else np.zeros(0),
                muv=acc._muv if acc.n else np.zeros(0),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_checkpoint(
    path: str,
) -> Optional[Tuple[EnsembleAccumulator, int, np.ndarray, np.ndarray]]:
    """Restore ``(accumulator, pairs_done, x, y)``; None if no checkpoint.

    A file that exists but cannot be parsed (external truncation /
    corruption — our own writes are atomic) reads as "no checkpoint"
    with a warning rather than crashing the resume: losing the resume
    point degrades to a from-scratch run, which is always safe."""
    if not os.path.exists(path):
        return None
    try:
        return _load(path)
    except Exception as e:
        import logging

        # what happens next is the caller's call (PIVRunner reruns from
        # scratch; merge_checkpoints refuses the merge) — don't promise
        # either here
        logging.getLogger("torchpiv_tpu_torch").warning(
            "checkpoint %s unreadable (%s) — treating as absent", path, e)
        return None


def _load(path):
    with np.load(path) as z:
        acc = EnsembleAccumulator()
        acc.n = int(z["n"])
        if acc.n:
            acc._mu = z["mu"]
            acc._mv = z["mv"]
            acc._muu = z["muu"]
            acc._mvv = z["mvv"]
            acc._muv = z["muv"]
        return acc, int(z["done"]), z["x"], z["y"]


def checkpoint_is_complete(path: str) -> bool:
    """True when the state was saved with ``complete=True`` (a finished
    shard); pre-flag files and resume checkpoints read as False."""
    with np.load(path) as z:
        return bool(z["complete"]) if "complete" in z.files else False
