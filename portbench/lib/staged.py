"""The closed loop over pairs staged on the device (``drive: staged``).

The mix's unique pairs sit on the device in a seeded order; batch ``i``
is the ``i``-th slice of ``batch`` pairs of that order, cycled.  The
issuing thread runs ``pipeline.packed_forward``, copies the packed result
``non_blocking`` into a free pinned buffer and records an event behind the
copy; at most ``inflight`` batches wait for a drainer thread, which waits
on each copy and hands the batch's pairs to the program's host tail
(``pipeline.tail_of``) on a pool of ``TAIL_THREADS`` without waiting for
the batch before it, so that no thread of the pool waits on the slowest
pair of a batch.  A collector takes the fields in order and frees a
batch's buffer once its tails have ended; the next batch goes as soon as a
buffer is free (``inflight + 2`` buffers).

The window opens when the collector has taken the loop's first batch, and
closes ``seconds`` later: a field counts where its tail ended inside.  The
issuing stops at the close; what is in flight is drained and checked, and
not counted.
"""
from __future__ import annotations

import queue
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .sample import Reservoir

DRIVE = True
# the tails run on this many threads, as the program's ``OfflinePIV``
# drainer does with its default four decode threads
TAIL_THREADS = 4


def _take(q: "queue.Queue", errors: list):
    """The next item of ``q``, or None once the drainer has failed."""
    while not errors:
        try:
            return q.get(timeout=0.5)
        except queue.Empty:
            continue
    return None


def _give(q: "queue.Queue", item, errors: list) -> bool:
    """Put ``item`` on ``q``; False once the drainer has failed."""
    while not errors:
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


def warm_engine(cell, device):
    """The engine, its tail and the warm-up: one dispatch at the batch and
    one host tail."""
    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models.multipass import MultipassPIV
    from torchpiv_tpu_torch.pipeline import packed_forward, tail_of

    cfg = cell.config
    engine = MultipassPIV(PIVConfig(frame_shape=tuple(cfg["frame_shape"]),
                                    **cfg["engine"]), device=device)
    tail = tail_of(engine, 1.0, 1.0)
    fa, fb = cell.frames
    B = cfg["batch"]
    with torch.no_grad():
        packed = packed_forward(engine, fa[:B], fb[:B]).cpu().numpy()
    tail(packed[0, 0], packed[0, 1], packed[0, 2] > 0.5)
    return engine, tail


def setup(cell, device, seconds: float, seed: int) -> dict:
    engine, tail = warm_engine(cell, device)
    return {"engine": engine, "tail": tail, "device": device}


def teardown(state: dict) -> None:
    state.clear()


def window(cell, state: dict, seconds: float, seed: int, traced: bool,
           on_open=None, on_close=None):
    """Run the window; returns the run's records (see ``cell.Records``)."""
    from torchpiv_tpu_torch.pipeline import packed_forward

    engine, tail, device = state["engine"], state["tail"], state["device"]
    cfg = cell.config
    B = cfg["batch"]
    inflight = int(cfg.get("inflight", 8))
    fa, fb = cell.frames
    n = fa.shape[0]
    cuda = device.type == "cuda"
    R, C = engine.final_field_shape
    free: "queue.Queue" = queue.Queue()
    for _ in range(inflight + 2):
        free.put(torch.empty((B, 3, R, C), dtype=torch.float32, pin_memory=cuda))
    pending: "queue.Queue" = queue.Queue(maxsize=inflight)
    tails: "queue.Queue" = queue.Queue()
    opened = threading.Event()
    state = {"t0": None, "t_end": None}
    done_t, tail_s, skipped = [], [], []
    sample = Reservoir(cell.check_pairs, random.Random(seed))
    errors = []
    STOP = object()

    def timed_tail(u, v, invalid):
        t = time.perf_counter()
        field = tail(u, v, invalid)
        return field, t, time.perf_counter()

    def drainer():
        try:
            while True:
                item = pending.get()
                if item is STOP:
                    tails.put(STOP)
                    return
                ids, host, copied = item
                if copied is not None:
                    copied.synchronize()
                arr = host.numpy()
                futs = [pool.submit(timed_tail, arr[j, 0], arr[j, 1], arr[j, 2] > 0.5)
                        for j in range(len(ids))]
                tails.put((ids, host, arr, futs))
        except BaseException as e:  # noqa: BLE001 - raised by the caller
            errors.append(e)
            opened.set()
            tails.put(STOP)

    def collector():
        try:
            while True:
                item = tails.get()
                if item is STOP:
                    return
                ids, host, arr, futs = item
                for j, (pid, fut) in enumerate(zip(ids, futs)):
                    field, t_begin, t_done = fut.result()
                    if opened.is_set():
                        tail_s.append(t_done - t_begin)
                        done_t.append(t_done)
                        if field is None:
                            skipped.append(pid)
                        if t_done <= state["t_end"]:
                            invalid = arr[j, 2] > 0.5
                            sample.offer(lambda: {"pair": pid, "field": field,
                                                  "invalid": invalid})
                free.put(host)
                if not opened.is_set():
                    state["t0"] = time.perf_counter()
                    state["t_end"] = state["t0"] + seconds
                    opened.set()
        except BaseException as e:  # noqa: BLE001 - raised by the caller
            errors.append(e)
            opened.set()

    spans = []
    pool = ThreadPoolExecutor(TAIL_THREADS, thread_name_prefix="portbench-tail")
    threads = [threading.Thread(target=f, name=f"portbench-{f.__name__}", daemon=True)
               for f in (drainer, collector)]
    for th in threads:
        th.start()
    i = 0
    marked = False
    with torch.no_grad():
        while not errors:
            if opened.is_set():
                if errors or time.perf_counter() >= state["t_end"]:
                    break
                if not marked:
                    marked = True
                    if on_open is not None:
                        on_open()
            host = _take(free, errors)
            if host is None:
                break
            s = (i * B) % n
            ids = [(s + j) % n for j in range(B)]
            marks = None
            if traced and cuda and marked:
                marks = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                marks[0].record()
            t = time.perf_counter()
            packed = packed_forward(engine, fa[s:s + B], fb[s:s + B])
            issue_s = time.perf_counter() - t
            copied = None
            if cuda:
                if marks is not None:
                    marks[1].record()
                host.copy_(packed, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
            else:
                host.copy_(packed)
            del packed
            if marked:
                spans.append({"pairs": B, "issue_s": issue_s, "marks": marks})
            if not _give(pending, (ids, host, copied), errors):
                break
            i += 1
        if on_close is not None and marked:
            on_close()
        _give(pending, STOP, errors)
        for th in threads:
            th.join()
        pool.shutdown()
    if errors:
        raise errors[0]
    if cuda:
        torch.cuda.synchronize(device)
    for sp in spans:
        m = sp.pop("marks")
        sp["device_ms"] = m[0].elapsed_time(m[1]) if m is not None else None
    t0, t_end = state["t0"], state["t_end"]
    in_window = sum(1 for t in done_t if t <= t_end)
    return {"t0": t0, "fields": in_window, "seconds": seconds,
            "attempted": len(done_t), "failed": len(skipped),
            "spans": spans, "tail_s": tail_s, "samples": sample.items}
