"""Threaded decode and host-to-device prefetch (counterpart of
``torchpiv_tpu/io/prefetch.py``).

A thread pool decodes batches ahead of the engine.  For a CUDA target each
worker also stages its batch in pinned host memory and issues the
host-to-device copy with ``non_blocking=True`` on a side stream, so decode,
staging and copies overlap the engine's work on earlier batches; the
consumer's current stream waits on the copy's event before the batch is
handed out.  Where the dataset's native decoder reads the frames
(``PIVDataset.native_shape``), a worker decodes a batch straight into pinned
staging from the caching host allocator, first frames then second ones,
and copies the two halves from there: no stack and no pinning copy.
"""
from __future__ import annotations

import collections
import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


class PairPrefetcher:
    """Iterate decoded, device-placed frame-pair batches.

    Args:
      dataset: a ``PIVDataset`` (``read_batch(indices, threads=, out=)``
        gives ``(ids, batch_a, batch_b)`` arrays, unreadable pairs dropped;
        its ``native_shape`` says whether it can decode into a buffer), or any
        indexable of ``(frame_a, frame_b)`` arrays with ``(None, None)`` for
        an unreadable pair (``PreprocessedPairs``).
      batch_size: pairs per yielded batch (the last batch may be short).
      device: target ``torch.device``.
      num_threads: decode worker threads.
      depth: how many batches to decode (and copy) ahead.
      first_batch_size: a smaller first batch, so that the first field
        arrives sooner; None or ``batch_size`` disables it.
      transfer_log: a list to which every placed batch appends
        ``(t_start, t_end, n_bytes)`` (``time.perf_counter`` seconds).  On
        CUDA ``t_end`` is taken after the copy's event has completed, which
        blocks the decode worker, not the consumer.
      spans: time each batch's decode and pinned staging on the host and its
        copy with CUDA events (see ``batches``).
      stream: the CUDA stream of the copies; None makes one for each
        iteration.
      pinned: keep the batches of a CPU ``device`` in pinned host memory, for
        a caller that places them on its devices itself (``ShardedPIV``).
      background: a uint8 ``[H, W]`` CPU tensor subtracted with saturation,
        in place, from every decoded batch on the decode worker (``a -
        min(a, background)``: the same bits as a subtract on the device).
    """

    def __init__(self, dataset, batch_size: int, device: torch.device,
                 num_threads: int = 4, depth: int = 2,
                 first_batch_size: Optional[int] = None,
                 transfer_log: Optional[list] = None, spans: bool = False,
                 stream: Optional[torch.cuda.Stream] = None,
                 pinned: bool = False,
                 background: Optional[torch.Tensor] = None):
        self.dataset = dataset
        self.batch_size = max(1, batch_size)
        self.device = device
        self.num_threads = max(1, num_threads)
        self.depth = max(1, depth)
        self.first_batch_size = first_batch_size or self.batch_size
        self.transfer_log = transfer_log
        self.spans = spans
        self.stream = stream
        self.pinned = pinned
        self.background = background

    def _decode(self, idxs: List[int], pinned: bool = False):
        """Decode one batch -> ``(ids, a, b)`` (numpy, or with ``pinned``
        and a native decoder pinned uint8 tensors), or None when no pair of
        it is readable."""
        if hasattr(self.dataset, "read_batch"):
            shape = getattr(self.dataset, "native_shape", None)
            staging = None
            if pinned and shape is not None:
                staging = torch.empty((2 * len(idxs), *shape), dtype=torch.uint8,
                                      pin_memory=True)
            ids, a, b = self.dataset.read_batch(
                idxs, threads=self.num_threads,
                out=None if staging is None else staging.numpy())
            if not ids:
                return None
            if staging is not None and len(ids) == len(idxs):
                n = len(ids)
                return ids, staging[:n], staging[n:]
            return ids, a, b
        pairs = [self.dataset[i] for i in idxs]
        keep = [(i, a, b) for i, (a, b) in zip(idxs, pairs)
                if a is not None and b is not None]
        if not keep:
            return None
        return ([i for i, _, _ in keep], np.stack([a for _, a, _ in keep]),
                np.stack([b for _, _, b in keep]))

    def _load(self, idxs: List[int], stream: Optional[torch.cuda.Stream]):
        """Decode one batch and place it (on a pool thread); returns
        ``(a, b, ids, copied_event, span)`` or None when no pair of it is
        readable."""
        t0 = time.perf_counter()
        decoded = self._decode(idxs, pinned=stream is not None or self.pinned)
        if decoded is None:
            return None
        ids, a, b = decoded
        if isinstance(a, np.ndarray):
            a, b = torch.from_numpy(a), torch.from_numpy(b)
        if self.background is not None:  # the decoded batch is ours
            a.sub_(torch.minimum(a, self.background))
            b.sub_(torch.minimum(b, self.background))
        t1 = time.perf_counter()
        nbytes = a.nbytes + b.nbytes
        span = {"decode_s": t1 - t0, "pin_s": 0.0, "h2d": None} if self.spans else None
        if stream is None:
            if self.pinned and not a.is_pinned():
                a, b = a.pin_memory(), b.pin_memory()
                if span is not None:
                    span["pin_s"] = time.perf_counter() - t1
            if self.transfer_log is not None:
                self.transfer_log.append((t1, time.perf_counter(), nbytes))
            return a, b, ids, None, span
        if not a.is_pinned():  # decoded in Python, or a pair was dropped
            a, b = a.pin_memory(), b.pin_memory()
        t2 = time.perf_counter()
        with torch.cuda.stream(stream):
            begun = None
            if span is not None:
                span["pin_s"] = t2 - t1
                begun = torch.cuda.Event(enable_timing=True)
                begun.record(stream)
            da = a.to(self.device, non_blocking=True)
            db = b.to(self.device, non_blocking=True)
            copied = torch.cuda.Event(enable_timing=span is not None)
            copied.record(stream)
        if span is not None:
            span["h2d"] = (begun, copied)
        if self.transfer_log is not None:
            copied.synchronize()
            self.transfer_log.append((t2, time.perf_counter(), nbytes))
        return da, db, ids, copied, span

    def batches(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, List[int], Optional[dict]]]:
        """Yields ``(batch_a, batch_b, pair_indices, span)``: ``[B, H, W]``
        tensors on the device, safe to read on the current stream.  With
        ``spans`` the span is ``{"decode_s", "pin_s", "h2d"}``, ``h2d`` the
        pair of CUDA events around the copy (None on the CPU); else None."""
        n = len(self.dataset)
        if n == 0:
            return
        b0 = max(1, min(self.first_batch_size, self.batch_size, n))
        todo = iter([list(range(0, b0))] + [
            list(range(i, min(i + self.batch_size, n)))
            for i in range(b0, n, self.batch_size)])
        stream = self.stream
        if stream is None and self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            futures = collections.deque(pool.submit(self._load, idxs, stream)
                                        for idxs in itertools.islice(todo, self.depth))
            while futures:
                loaded = futures.popleft().result()
                idxs = next(todo, None)
                if idxs is not None:
                    futures.append(pool.submit(self._load, idxs, stream))
                if loaded is None:
                    continue
                a, b, ids, copied, span = loaded
                if copied is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(copied)
                    # the tensors were allocated on the side stream
                    a.record_stream(consumer)
                    b.record_stream(consumer)
                yield a, b, ids, span

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, List[int]]]:
        """Yields ``(batch_a, batch_b, pair_indices)`` (see ``batches``)."""
        for a, b, ids, _ in self.batches():
            yield a, b, ids
