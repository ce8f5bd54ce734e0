"""Image-pair dataset over a folder of frames (numpy).

Copy of ``torchpiv_tpu/io/dataset.py``: list files by extension,
natural-sort, pair them ``(0,1),(2,3),...`` ("pairs") or ``(0,1),(1,2),...``
("sequential"), decode to uint8 grayscale; unreadable pairs yield
``(None, None)`` and are skipped by the pipeline.  ``read_batch`` decodes
whole batches with the port's native bulk decoder (``native.loader``) where
it takes the first frame, else with the per-file Python decoders.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from ..native import loader as native
from .decode import imread_gray


def atoi(text: str):
    """A run of digits as its int, any other text as it is."""
    return int(text) if text.isdigit() else text


def natural_keys(text: str):
    """Human-order sort key: 'img2' < 'img10'.  (Copy of ``atoi`` and
    ``natural_keys`` in ``torchpiv_tpu/utils/persistence.py``.)"""
    return [atoi(c) for c in re.split(r"(\d+)", text)]


def compute_background(dataset, n_pairs: int = 20) -> Optional[np.ndarray]:
    """Temporal-minimum background image over the first ``n_pairs`` pairs.
    (Copy of ``compute_background`` in ``torchpiv_tpu/io/dataset.py``.)

    Stationary glare and wall reflections survive a per-pixel minimum while
    moving particles do not; subtracting it before analysis raises the
    correlation's signal-to-noise ratio.
    """
    bg = None
    count = 0
    for i in range(min(len(dataset), n_pairs)):
        a, b = dataset[i]
        if a is None:
            continue
        m = np.minimum(a, b)
        bg = m if bg is None else np.minimum(bg, m)
        count += 1
    return bg if count else None


def list_pairs(folder: str, file_fmt: str, folder_mode: str) -> List[Tuple[str, str]]:
    filenames = [
        os.path.join(folder, name)
        for name in os.listdir(folder)
        if name.endswith(file_fmt)
    ]
    filenames.sort(key=natural_keys)
    if folder_mode == "pairs":
        return list(zip(filenames[::2], filenames[1::2]))
    if folder_mode == "sequential":
        return list(zip(filenames[:-1], filenames[1:]))
    return []


class PIVDataset:
    """Indexable dataset of decoded uint8 grayscale frame pairs.

    ``read_batch`` is the bulk path the prefetcher uses: where the native
    decoder takes the first pair's first frame (``native_shape``, its
    ``(H, W)``), it reads and decodes whole batches on C++ threads with the
    interpreter lock released; else the per-file Python decoders run.
    """

    def __init__(self, folder: str, file_fmt: str, folder_mode: str = "pairs"):
        self.folder = folder
        self.img_pairs = list_pairs(folder, file_fmt, folder_mode)
        self.native_shape = None
        if self.img_pairs:
            self.native_shape = native.probe_gray(self.img_pairs[0][0])

    def __len__(self) -> int:
        return len(self.img_pairs)

    def __getitem__(
        self, index: int
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        name_a, name_b = self.img_pairs[index]
        frame_b = imread_gray(name_b)
        frame_a = imread_gray(name_a)
        if frame_a is None or frame_b is None:
            return None, None
        return frame_a, frame_b

    def read_batch(self, indices, threads: int = 8,
                   out: Optional[np.ndarray] = None):
        """Decode pairs for ``indices`` -> ``(ids, batch_a, batch_b)`` on
        ``threads`` decoder threads; a pair with an unreadable frame, or a
        frame of another shape than the first readable one, is dropped
        (``[], None, None`` when none is left).  ``out``, a uint8 ``[2n, H,
        W]`` array (native decoder only), receives the first frames of the
        ``n`` pairs, then the second ones; where every pair is read,
        ``batch_a`` and ``batch_b`` are its two halves, else copies of the
        pairs kept."""
        if self.native_shape is not None:
            n = len(indices)
            paths = ([self.img_pairs[i][0] for i in indices]
                     + [self.img_pairs[i][1] for i in indices])
            frames, status = native.read_batch_gray(paths, self.native_shape,
                                                    threads, out=out)
            ok = [j for j in range(n) if status[j] == 0 and status[n + j] == 0]
            if len(ok) == n:
                return list(indices), frames[:n], frames[n:]
            if not ok:
                return [], None, None
            return ([indices[j] for j in ok], frames[ok],
                    frames[[n + j for j in ok]])
        if out is not None:
            raise ValueError("read_batch(out=...) needs the native decoder")
        pairs = [self[i] for i in indices]
        keep = [
            (i, a, b)
            for i, (a, b) in zip(indices, pairs)
            if a is not None and b is not None
        ]
        if keep:
            shape = keep[0][1].shape
            keep = [t for t in keep if t[1].shape == shape and t[2].shape == shape]
        if not keep:
            return [], None, None
        return (
            [i for i, _, _ in keep],
            np.stack([a for _, a, _ in keep]),
            np.stack([b for _, _, b in keep]),
        )
