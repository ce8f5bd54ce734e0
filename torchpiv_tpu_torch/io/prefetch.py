"""Threaded decode and host-to-device prefetch (counterpart of
``torchpiv_tpu/io/prefetch.py``).

A thread pool decodes batches ahead of the engine and stages each one in a
pinned host tensor.  For a CUDA target the host-to-device copy is issued
with ``non_blocking=True`` on a side stream one batch ahead, so it overlaps
the engine's work on the previous batch; the consumer's stream waits on the
copy's event before the batch is handed out.
"""
from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import torch


class PairPrefetcher:
    """Iterate decoded, device-placed frame-pair batches.

    Args:
      dataset: a ``PIVDataset`` (``read_batch(indices)`` gives
        ``(ids, batch_a, batch_b)`` uint8 arrays, unreadable pairs dropped).
      batch_size: pairs per yielded batch (the last batch may be short).
      device: target ``torch.device``.
      num_threads: decode worker threads.
      depth: how many batches to decode ahead.
    """

    def __init__(self, dataset, batch_size: int, device: torch.device,
                 num_threads: int = 4, depth: int = 2):
        self.dataset = dataset
        self.batch_size = max(1, batch_size)
        self.device = device
        self.num_threads = max(1, num_threads)
        self.depth = max(1, depth)

    def _load(self, idxs: List[int]):
        ids, a, b = self.dataset.read_batch(idxs)
        if not ids:
            return None
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        if self.device.type == "cuda":
            a, b = a.pin_memory(), b.pin_memory()
        return a, b, ids

    def _upload(self, host, stream):
        """Start the host-to-device copy of one batch on ``stream``."""
        a, b, ids = host
        if stream is None:
            return a, b, ids, None
        with torch.cuda.stream(stream):
            da = a.to(self.device, non_blocking=True)
            db = b.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return da, db, ids, done

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, List[int]]]:
        """Yields ``(batch_a, batch_b, pair_indices)``: ``[B, H, W]`` uint8
        tensors on the device, safe to read on the current stream."""
        n = len(self.dataset)
        if n == 0:
            return
        batches = [list(range(i, min(i + self.batch_size, n)))
                   for i in range(0, n, self.batch_size)]
        stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            futures = collections.deque(
                pool.submit(self._load, idxs) for idxs in batches[:self.depth])
            todo = iter(batches[self.depth:])

            def next_upload():
                # the next readable batch, its copy started
                while futures:
                    host = futures.popleft().result()
                    idxs = next(todo, None)
                    if idxs is not None:
                        futures.append(pool.submit(self._load, idxs))
                    if host is not None:
                        return self._upload(host, stream)
                return None

            nxt = next_upload()
            while nxt is not None:
                da, db, ids, done = nxt
                nxt = next_upload()  # copy one batch ahead
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    # the tensors were allocated on the side stream
                    da.record_stream(consumer)
                    db.record_stream(consumer)
                yield da, db, ids
