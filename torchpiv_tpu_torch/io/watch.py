"""Streaming ("online") frame-pair sources (copy of
``torchpiv_tpu/io/watch.py``).

The reference's online mode is an unfinished stub (OnlineWorker crashes at
construction, workers.py:128-150; the watchdog script watchman.py is never
invoked).  What it *intended* — process pairs as a camera writes them — is
implemented here for real: a polling directory watcher with the reference's
``_a``/``_b`` filename pairing rules (workers.py:169-178), usable as an
iterator that blocks until new pairs arrive or a stop event fires.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Iterator, List, Optional, Tuple

from .dataset import natural_keys

log = logging.getLogger("torchpiv_tpu_torch")


class WatchMan:
    """Polling watcher: diffs the folder listing and pairs new files.

    Pairing mirrors the reference's four alignment cases on the ``_a``/``_b``
    suffix of the first new file and the parity of the count
    (workers.py:169-178).
    """

    def __init__(self, folder: str, file_fmt: str):
        self.folder = folder
        self.file_fmt = file_fmt
        self.filenames = self._listing()
        self.img_pairs: List[Tuple[str, str]] = []

    def _listing(self) -> set:
        return {
            os.path.join(self.folder, name)
            for name in os.listdir(self.folder)
            if name.endswith(self.file_fmt)
        }

    def update(self) -> List[Tuple[str, str]]:
        filenames = self._listing()
        new_files = list(filenames.difference(self.filenames))
        self.filenames = filenames
        self.set_image_pairs(new_files)
        return self.img_pairs

    def set_image_pairs(self, new_files: List[str]) -> None:
        if not new_files:
            self.img_pairs = []
            return
        new_files.sort(key=natural_keys)
        fmt = self.file_fmt
        even = len(new_files) % 2 == 0
        if new_files[0].endswith("_a" + fmt):
            if even:
                self.img_pairs = list(zip(new_files[::2], new_files[1::2]))
            else:
                self.img_pairs = list(zip(new_files[:-1:2], new_files[1:-1:2]))
        elif new_files[0].endswith("_b" + fmt):
            if even:
                self.img_pairs = list(zip(new_files[1:-1:2], new_files[2:-1:2]))
            else:
                self.img_pairs = list(zip(new_files[1::2], new_files[2::2]))
        else:
            self.img_pairs = []


class StreamingPairSource:
    """Blocking iterator of new image-pair paths appearing in a folder.

    Used by ``OnlinePIV``.  Stops when ``stop()`` is called or after
    ``idle_timeout`` seconds without new files (None = wait forever).

    Unlike ``WatchMan`` (which, like the reference, only pairs files that
    appeared within a single poll and silently drops odd leftovers), this
    keeps a pending buffer across polls, so an ``_a`` frame seen in one poll
    pairs with its ``_b`` frame arriving in the next.
    """

    def __init__(
        self,
        folder: str,
        file_fmt: str,
        poll_interval: float = 0.2,
        idle_timeout: Optional[float] = None,
        orphan_timeout: Optional[float] = 300.0,
    ):
        self.folder = folder
        self.file_fmt = file_fmt
        self.poll_interval = poll_interval
        self.idle_timeout = idle_timeout
        # unmatched _a/_b frames are retained across polls so out-of-order
        # writes can pair up — but not forever: a frame whose mate never
        # arrives (camera dropped it, file deleted) is evicted after this
        # many seconds, bounding the pending buffer over long acquisitions.
        # None = retain forever.
        self.orphan_timeout = orphan_timeout
        self._seen = self._listing()
        self._pending: List[str] = []
        self._first_seen: dict = {}
        self._stop = threading.Event()

    def _listing(self) -> set:
        return {
            os.path.join(self.folder, name)
            for name in os.listdir(self.folder)
            if name.endswith(self.file_fmt)
        }

    def stop(self) -> None:
        self._stop.set()

    def _poll(self) -> List[Tuple[str, str]]:
        listing = self._listing()
        new = sorted(listing - self._seen, key=natural_keys)
        self._seen = listing
        now = time.monotonic()
        for name in new:
            self._first_seen[name] = now
        self._pending.extend(new)
        self._pending.sort(key=natural_keys)
        pairs = []
        keep: List[str] = []
        i = 0
        fmt = self.file_fmt
        suf = len("_a" + fmt)
        while i < len(self._pending):
            name = self._pending[i]
            if not name.endswith("_a" + fmt):
                if name.endswith("_b" + fmt):
                    # _b visible before its _a (out-of-order writes):
                    # retain it so the pair forms when the _a lands
                    keep.append(name)
                i += 1  # unsuffixed file: drop
                continue
            if i + 1 < len(self._pending):
                mate = self._pending[i + 1]
                if mate.endswith("_b" + fmt) and mate[:-suf] == name[:-suf]:
                    pairs.append((name, mate))
                    i += 2
                    continue
            # ``_a`` whose ``_b`` hasn't landed yet: retain it across polls
            # (writes may arrive out of order — img2_a/_b before img1_b)
            keep.append(name)
            i += 1
        if self.orphan_timeout is not None:
            aged = [n for n in keep
                    if now - self._first_seen.get(n, now)
                    > self.orphan_timeout]
            if aged:
                log.warning(
                    "online: dropping %d unmatched frame(s) older than "
                    "%.0f s (mate never arrived): %s%s", len(aged),
                    self.orphan_timeout, os.path.basename(aged[0]),
                    "" if len(aged) == 1 else ", ...")
                keep = [n for n in keep if n not in set(aged)]
        self._pending = keep
        done = set(self._first_seen) - set(keep)
        for n in done:
            del self._first_seen[n]
        return pairs

    def ready(self) -> List[Tuple[str, str]]:
        """Non-blocking: pairs already visible on disk right now (no poll
        wait).  Safe to interleave with iteration from the same thread —
        consumers use it to drain a backlog for batched catch-up dispatch
        (``OnlinePIV(catchup_batch=...)``)."""
        return self._poll()

    def bursts(self) -> Iterator[List[Tuple[str, str]]]:
        """Iterate LISTS of pairs, one per poll — a burst is everything the
        camera wrote since the last look.  Burst size is the consumer's
        backlog signal: >1 means it is falling behind and can amortise
        fixed dispatch overhead by batching (``OnlinePIV`` catch-up)."""
        last_new = time.monotonic()
        while not self._stop.is_set():
            pairs = self._poll()
            if pairs:
                last_new = time.monotonic()
                yield pairs
            elif (
                self.idle_timeout is not None
                and time.monotonic() - last_new > self.idle_timeout
            ):
                return
            else:
                self._stop.wait(self.poll_interval)
        # stop() means "no more frames are coming": drain what already landed
        tail = self._poll()
        if tail:
            yield tail

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        for burst in self.bursts():
            yield from burst
