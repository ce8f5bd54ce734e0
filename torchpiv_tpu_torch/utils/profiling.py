"""Structured timing + profiling (copy of ``torchpiv_tpu/utils/profiling.py``;
``device_trace`` wraps ``torch.profiler`` where the JAX module wraps
``jax.profiler``).

The reference instruments with inline ``print`` of wall-clock deltas in the
hot loop (PIVbackend.py:866-871, 902-903, 739; workers.py:83).  Here: named
stage timers with aggregate stats, a pairs/s throughput meter, and a context
wrapper around ``torch.profiler`` for device-level traces.

The engine's own spans (``span``, ``engine_call``, ``count``, read through
``calls``) record only while ``torch.profiler`` is active, a flag that every
thread sees, so the program's threads that the profiler does not capture
record too.  Off, ``span`` and ``engine_call`` return one shared no-op
context (``OFF``): no range, no CUDA event, no record.  On, a span opens a
host range of the profiler (``_range``), takes ``time.time_ns()`` at its
start and end
(the clock of the profiler's own events) and, inside an engine call on a
CUDA device, records a timing event pair on the stream that was current at
the call's entry.  The spans of one ``engine_call`` and its counters make
one ``CallRecord``.  Nothing waits for the card: a call's events are turned
into milliseconds, and its counters into numbers, once its last event has
completed, checked at the next call's entry or when ``calls`` is read, and
then released.  A span opened outside an engine call is a profiler range and
nothing else.

The range is an operator-scope one (``_RecordFunctionFast``), not
``record_function``'s user scope: the profiler turns a user-scope range
into a device-side annotation as long as the kernels it launched, which a
reader of the trace's device events would count as busy time.  An
operator-scope range is a host event only: the kernels link to their
launches inside it, and a device gap is named by the stage the host was in.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


CALL = "piv.call"
KEEP_CALLS = 65536  # the newest records kept in memory


@dataclass
class SpanRecord:
    """A span of an engine call: ``time.time_ns()`` at its start and end, its
    host ms, and its device ms (None off CUDA).  ``parent`` is the id of the
    call a stage belongs to (None for the call's own span)."""

    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: int
    host_ms: float
    device_ms: Optional[float] = None


@dataclass
class CallRecord:
    """One engine call: its pairs, its final-grid vectors (pairs x rows x
    columns), its own span (``piv.call``), its stage spans in order, and its
    counters (``flagged``: the final field's invalid vectors)."""

    id: int
    pairs: int
    vectors: int
    call: Optional[SpanRecord] = None
    spans: List[SpanRecord] = field(default_factory=list)
    counts: Dict[str, int] = field(default_factory=dict)


class _Off:
    """The one context every span returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()
_range = torch._C._profiler._RecordFunctionFast
_ids = itertools.count(1)
_lock = threading.Lock()
_done: deque = deque(maxlen=KEEP_CALLS)  # settled records, oldest first
_pending: deque = deque()  # closed calls whose events may still be running
_local = threading.local()  # ``open``: this thread's call; ``last``: its id


class _Span:
    """A recording span; ``call`` is the engine call it belongs to, or None."""

    __slots__ = ("name", "call", "range", "start", "events")

    def __init__(self, name: str, call: Optional["_Call"]):
        self.name = name
        self.call = call
        self.events = None

    def __enter__(self):
        self.range = _range(self.name)
        self.range.__enter__()
        stream = None if self.call is None else self.call.stream
        if stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.call.stream)
        if self.call is not None:
            self.call.add(SpanRecord(self.name, self.call.record.id, self.start, end,
                                     (end - self.start) / 1e6), self.events)
        self.range.__exit__(*exc)
        return False


class _Call(_Span):
    """The span of one engine call, which files the call's record."""

    __slots__ = ("record", "stream", "stage_events", "counts", "outer")

    def __init__(self, device: torch.device, pairs: int, vectors: int):
        super().__init__(CALL, None)
        self.call = self
        self.record = CallRecord(next(_ids), pairs, vectors)
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self.stage_events: list = []
        self.counts: dict = {}

    def add(self, rec: SpanRecord, events) -> None:
        self.record.spans.append(rec)
        self.stage_events.append(events)

    def __enter__(self):
        _settle(wait=False)
        self.outer = getattr(_local, "open", None)
        super().__enter__()
        _local.open = self
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        _local.open = self.outer
        self.record.call = SpanRecord(CALL, None, self.start, end,
                                      (end - self.start) / 1e6)
        self.range.__exit__(*exc)
        with _lock:
            _pending.append(self)
        _local.last = self.record.id
        return False

    def finished(self) -> bool:
        return self.events is None or self.events[1].query()

    def settle(self) -> CallRecord:
        """Device ms and counters into the record; the events go."""
        rec = self.record
        for s, ev in zip([rec.call] + rec.spans, [self.events] + self.stage_events):
            if ev is not None:
                s.device_ms = ev[0].elapsed_time(ev[1])
        rec.counts = {k: int(v) for k, v in self.counts.items()}
        self.events = self.stage_events = self.counts = None
        return rec


def _settle(wait: bool) -> None:
    """File the closed calls whose last event has completed, in order;
    ``wait`` first waits for the card to reach them all."""
    if wait:
        with _lock:
            todo = list(_pending)
        for c in todo:
            if c.events is not None:
                c.events[1].synchronize()
    with _lock:
        while _pending and _pending[0].finished():
            _done.append(_pending.popleft().settle())


def span(name: str):
    """A stage span (see the module docstring): ``with span(name): ...``."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _Span(name, getattr(_local, "open", None))


def engine_call(device: torch.device, pairs: int, vectors: int):
    """The span of one engine call (``piv.call``), whose record holds the
    stage spans opened inside it on this thread."""
    if not _autograd_profiler._is_profiler_enabled:
        _local.last = None
        return OFF
    return _Call(device, pairs, vectors)


def count(name: str, mask: Optional[torch.Tensor]) -> None:
    """Counter ``name`` of the open engine call on this thread: the True
    elements of ``mask`` (0 for None), counted on the device and copied to
    pinned memory behind the call's work, so that nothing waits.  Nothing
    outside a recording call."""
    call = getattr(_local, "open", None)
    if call is None:
        return
    if mask is None:
        call.counts[name] = 0
        return
    n = mask.sum()
    if n.is_cuda:
        host = torch.empty((), dtype=n.dtype, pin_memory=True)
        host.copy_(n, non_blocking=True)
        n = host
    call.counts[name] = n


def last_call() -> Optional[int]:
    """The id of the newest engine call this thread made while recording
    (None after a call made with recording off)."""
    return getattr(_local, "last", None)


def calls() -> List[CallRecord]:
    """The newest ``KEEP_CALLS`` records, oldest first.  Waits for the card
    to finish the calls still pending: read it off the engine's path."""
    _settle(wait=True)
    with _lock:
        return list(_done)
