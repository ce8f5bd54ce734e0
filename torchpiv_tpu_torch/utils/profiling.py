"""Structured timing + profiling (copy of ``torchpiv_tpu/utils/profiling.py``;
``device_trace`` wraps ``torch.profiler`` where the JAX module wraps
``jax.profiler``).

The reference instruments with inline ``print`` of wall-clock deltas in the
hot loop (PIVbackend.py:866-871, 902-903, 739; workers.py:83).  Here: named
stage timers with aggregate stats, a pairs/s throughput meter, and a context
wrapper around ``torch.profiler`` for device-level traces.
"""
from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

log = logging.getLogger("torchpiv_tpu_torch")


class StageTimers:
    """Accumulates wall-clock per named stage; ``report()`` logs a summary."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            out[name] = {"total_s": total, "count": n, "mean_ms": 1000 * total / n}
            log.info("stage %-20s total %8.3f s  n=%5d  mean %7.2f ms",
                     name, total, n, 1000 * total / n)
        return out


class Throughput:
    """Pairs-per-second meter (the BASELINE metric)."""

    def __init__(self):
        self.start: Optional[float] = None
        self.count = 0

    def tick(self, n: int = 1) -> None:
        if self.start is None:
            self.start = time.perf_counter()
        self.count += n

    @property
    def pairs_per_sec(self) -> float:
        if not self.start or not self.count:
            return 0.0
        return self.count / (time.perf_counter() - self.start)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler.profile`` wrapper (no-op when logdir is None): the
    host's operators and, where CUDA is available, the card's kernels,
    written on exit as a Chrome trace ``trace.json`` into ``logdir``
    (``chrome://tracing``, Perfetto or TensorBoard read it)."""
    if logdir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
