"""Pipeline layer: ``OfflinePIV`` and the per-pair host tail (counterpart of
``torchpiv_tpu/pipeline.py``).

``OfflinePIV`` keeps the reference constructor ``(folder, device, file_fmt,
wind_size, overlap, multipass, multipass_mode, dt, scale, multipass_scale,
folder_mode)``; calling it returns a generator of ``(x, y, u, v)`` numpy
fields per image pair, with the validation NaN/infill tail, the axis flip
and the physical-unit conversion.

Per batch the engine runs once over ``[B, H, W]`` frames, its results are
packed into one ``[B, 3, R, C]`` float32 tensor (``u``, ``v``, invalid) and
copied to the host once.  Decoding and the host-to-device copies run ahead
in ``io.prefetch``; the host tail of a batch runs on a thread pool while the
card computes the next batch.
"""
from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Generator, Optional, Tuple

import numpy as np
import torch

from .config import PIVConfig
from .io.dataset import PIVDataset
from .io.decode import imread_gray
from .io.prefetch import PairPrefetcher
from .models.multipass import MultipassPIV
from .ops.infill import fill_missing_values, interpolate_borders
from .utils.device import resolve_device

log = logging.getLogger("torchpiv_tpu_torch")


def finalize_fields(
    u: np.ndarray,
    v: np.ndarray,
    invalid: Optional[np.ndarray],
    x: np.ndarray,
    y: np.ndarray,
    scale: float,
    dt: float,
    static_mask: Optional[np.ndarray] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """The reference's per-pair tail: NaN the invalid vectors, border-interp
    + Delaunay infill (None = skip the pair when more than half is invalid),
    flip to the physical y-axis, convert to mm and m/s.

    ``static_mask`` marks the windows that a region-of-interest mask
    excludes: they are reported as zero displacement, not infilled, and do
    not count towards the skip rule."""
    u = np.array(u, dtype=np.float64)
    v = np.array(v, dtype=np.float64)
    if static_mask is not None:
        static_mask = np.asarray(static_mask, dtype=bool)
        u[static_mask] = 0.0
        v[static_mask] = 0.0
        if invalid is not None:
            invalid = np.asarray(invalid) & ~static_mask
    if invalid is not None:
        invalid = np.asarray(invalid)
        u[invalid] = np.nan
        v[invalid] = np.nan
        u = interpolate_borders(u)
        v = interpolate_borders(v)
        u = fill_missing_values(u)
        v = fill_missing_values(v)
        if u is None or v is None:
            return None
    u = np.flip(u, axis=0)
    v = -np.flip(v, axis=0)
    u = u * scale / dt * 1000
    v = v * scale / dt * 1000
    return x * scale, y * scale, u, v


def packed_forward(engine: MultipassPIV, frame_a: torch.Tensor,
                   frame_b: torch.Tensor) -> torch.Tensor:
    """The engine over a ``[B, H, W]`` batch, packed per pair into one
    ``[B, 3, R, C]`` float32 tensor: ``u``, ``v`` and invalid (0/1)."""
    u, v, inval = engine(frame_a, frame_b)
    if inval is None:
        inval = torch.zeros_like(u, dtype=torch.bool)
    return torch.stack([u, v, inval.to(u.dtype)], dim=1)


def resolve_frame_mask(mask):
    """A region-of-interest mask argument as a bool array: ``None``, a
    ``[H, W]`` bool-like array (True = excluded), or the path of a mask
    image whose non-zero pixels are excluded."""
    if mask is None:
        return None
    if isinstance(mask, str):
        arr = imread_gray(mask)
        if arr is None:
            raise ValueError(f"unreadable mask image: {mask}")
        return arr > 0
    return np.asarray(mask).astype(bool)


class OfflinePIV:
    """Folder -> generator of (x, y, u, v) fields.  The reference API.

    Keyword-only knobs beyond the reference signature: ``batch_size``
    (pairs per engine call), ``validate``/``val_ratio``, ``decode_threads``,
    ``skip_pairs``/``max_pairs``, and any ``PIVConfig`` field via
    ``engine_options``.  ``engine_options`` also takes ``frame_mask`` (a
    ``[H, W]`` bool array, True = excluded, or the path of a mask image) and
    ``mask_threshold``: masked windows come out with zero displacement.
    ``device`` defaults to the CUDA card.
    """

    def __init__(
        self,
        folder: str,
        device: str = "auto",
        file_fmt: str = ".bmp",
        wind_size: int = 64,
        overlap: int = 32,
        multipass: int = 1,
        multipass_mode: str = "CWS",
        dt: float = 1,
        scale: float = 1.0,
        multipass_scale: float = 2.0,
        folder_mode: str = "pairs",
        *,
        batch_size: int = 4,
        validate: bool = True,
        val_ratio: float = 1.2,
        decode_threads: int = 4,
        skip_pairs: int = 0,
        max_pairs: Optional[int] = None,
        background="none",
        preprocess="none",
        engine_options: Optional[dict] = None,
    ) -> None:
        if not (isinstance(background, str) and background == "none"):
            raise ValueError("background subtraction is not ported to the "
                             "PyTorch engine yet (background='none')")
        if not (isinstance(preprocess, str) and preprocess == "none"):
            raise ValueError("frame preprocessing is not ported to the "
                             "PyTorch engine yet (preprocess='none')")
        engine_options = dict(engine_options or {})
        frame_mask = resolve_frame_mask(engine_options.pop("frame_mask", None))
        mask_threshold = engine_options.pop("mask_threshold", 0.5)
        self._dt = dt
        self._scale = scale
        self._batch = max(1, batch_size)
        self._device = resolve_device(device)
        self._decode_threads = decode_threads
        self._dataset = PIVDataset(folder, file_fmt, folder_mode)
        if skip_pairs:  # resume support: pairs are consumed in sorted order
            self._dataset.img_pairs = self._dataset.img_pairs[skip_pairs:]
        if max_pairs is not None:
            self._dataset.img_pairs = self._dataset.img_pairs[:max_pairs]
        self._engine_kwargs = dict(
            wind_size=wind_size,
            overlap=overlap,
            multipass=multipass,
            multipass_mode=multipass_mode,
            multipass_scale=multipass_scale,
            validate=validate,
            val_ratio=val_ratio,
            **engine_options,
        )
        self._engine: Optional[MultipassPIV] = None
        # the engine is built for the shape of the first readable pair
        for i in range(len(self._dataset)):
            frame_a, _ = self._dataset[i]
            if frame_a is not None:
                cfg = PIVConfig(frame_shape=tuple(frame_a.shape),
                                **self._engine_kwargs)
                self._engine = MultipassPIV(cfg, device=self._device,
                                            frame_mask=frame_mask,
                                            mask_threshold=mask_threshold)
                break

    @property
    def engine(self) -> Optional[MultipassPIV]:
        return self._engine

    def __len__(self) -> int:
        return len(self._dataset)

    def __call__(self) -> Generator:
        if self._engine is None:
            return
        engine = self._engine
        x, y = engine.final_coordinates
        # the host NaN + infill tail runs only for infill="host": "fused"
        # is filled on the device already, "none" asks for raw vectors
        tail_validates = engine.config.validate and engine.config.infill == "host"
        static_mask = engine.window_masked[-1]
        if static_mask is not None:
            static_mask = static_mask.cpu().numpy()
        prefetch = PairPrefetcher(self._dataset, self._batch, self._device,
                                  num_threads=self._decode_threads, depth=2)

        def tail(ids, packed):
            return [(pid, finalize_fields(
                        packed[i, 0], packed[i, 1],
                        packed[i, 2] > 0.5 if tail_validates else None,
                        x, y, self._scale, self._dt, static_mask))
                    for i, pid in enumerate(ids)]

        with ThreadPoolExecutor(max_workers=max(1, self._decode_threads)) as pool:
            pending = None  # host tail of the previous batch
            for batch_a, batch_b, ids in prefetch:
                packed = packed_forward(engine, batch_a, batch_b).cpu().numpy()
                done, pending = pending, pool.submit(tail, ids, packed)
                if done is not None:
                    yield from self._emit(done.result())
            if pending is not None:
                yield from self._emit(pending.result())

    @staticmethod
    def _emit(results):
        for pid, res in results:
            if res is None:
                log.warning("pair %d skipped: too many invalid vectors", pid)
                continue
            yield res
