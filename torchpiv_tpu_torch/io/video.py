"""Video-file frame-pair source (copy of ``torchpiv_tpu/io/video.py``).

The reference exposes a "PIV Video File" menu entry
(``mainWindow.py:79-86``, ``ControlsWidgets.py:503-505``) whose handler merely stores the chosen filename
as the analysis "folder" — the intent (PIV over a video's frame stream)
never worked.  This module implements that intent for real, the same way
``OnlinePIV`` realised the broken online stub: decode frames with
``cv2.VideoCapture``, convert to uint8 grayscale, and pair them either
``(0,1),(2,3),…`` ("pairs", double-pulse cameras) or ``(0,1),(1,2),…``
("sequential", continuous video).
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover - cv2 is present in CI images
    cv2 = None


class VideoPairSource:
    """Iterable of ``(frame_a, frame_b)`` uint8 grayscale pairs from a video.

    Args:
      path: video file readable by OpenCV.
      folder_mode: "pairs" (frames 0-1, 2-3, ...) or "sequential"
        (frames 0-1, 1-2, ...), mirroring ``PIVDataset``'s pairing modes.
      max_pairs: optional cap on the number of pairs yielded.
    """

    def __init__(self, path: str, folder_mode: str = "sequential",
                 max_pairs: Optional[int] = None):
        if cv2 is None:
            raise RuntimeError("video sources require OpenCV (cv2)")
        if folder_mode not in ("pairs", "sequential"):
            raise ValueError(f"unknown folder_mode {folder_mode!r}")
        self.path = path
        self.folder_mode = folder_mode
        self.max_pairs = max_pairs
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise OSError(f"cannot open video file {path!r}")
        self.frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.frame_shape = (
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        )
        cap.release()

    def __len__(self) -> int:
        n = self.frame_count
        total = n // 2 if self.folder_mode == "pairs" else max(0, n - 1)
        if self.max_pairs is not None:
            total = min(total, self.max_pairs)
        return total

    @staticmethod
    def _gray(frame: np.ndarray) -> np.ndarray:
        if frame.ndim == 3:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        return np.asarray(frame, dtype=np.uint8)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        cap = cv2.VideoCapture(self.path)
        try:
            prev = None
            yielded = 0
            while True:
                if self.max_pairs is not None and yielded >= self.max_pairs:
                    return
                ok, frame = cap.read()
                if not ok:
                    return
                frame = self._gray(frame)
                if prev is None:
                    prev = frame
                    continue
                yield prev, frame
                yielded += 1
                prev = None if self.folder_mode == "pairs" else frame
        finally:
            cap.release()
