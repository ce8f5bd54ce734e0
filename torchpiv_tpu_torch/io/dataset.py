"""Image-pair dataset over a folder of frames (numpy).

Copy of ``torchpiv_tpu/io/dataset.py`` without the native bulk decoder:
list files by extension, natural-sort, pair them ``(0,1),(2,3),...``
("pairs") or ``(0,1),(1,2),...`` ("sequential"), decode to uint8 grayscale;
unreadable pairs yield ``(None, None)`` and are skipped by the pipeline.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from .decode import imread_gray


def natural_keys(text: str):
    """Human-order sort key: 'img2' < 'img10'.  (Copy of ``natural_keys``
    in ``torchpiv_tpu/utils/persistence.py``.)"""
    return [int(c) if c.isdigit() else c for c in re.split(r"(\d+)", text)]


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
    """Indexable dataset of decoded uint8 grayscale frame pairs."""

    def __init__(self, folder: str, file_fmt: str, folder_mode: str = "pairs"):
        self.folder = folder
        self.img_pairs = list_pairs(folder, file_fmt, folder_mode)

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

    def read_batch(self, indices):
        """Decode pairs for ``indices`` -> ``(ids, batch_a, batch_b)``;
        unreadable pairs, and pairs of another frame shape than the first
        readable one, are dropped."""
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
