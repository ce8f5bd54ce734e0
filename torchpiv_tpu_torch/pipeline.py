"""Pipeline layer: ``OfflinePIV`` and the per-pair host tail (counterpart of
``torchpiv_tpu/pipeline.py``).

``OfflinePIV`` keeps the reference constructor ``(folder, device, file_fmt,
wind_size, overlap, multipass, multipass_mode, dt, scale, multipass_scale,
folder_mode)``; calling it returns a generator of ``(x, y, u, v)`` numpy
fields per image pair, with the validation NaN/infill tail, the axis flip
and the physical-unit conversion.

Calling it runs the JAX ``OfflinePIV``'s three stages, each on its own
thread(s): the prefetcher's pool decodes (and preprocesses) frames and
copies them to the device (``io.prefetch``); a feeder thread applies the
background and runs the engine over ``[B, H, W]`` batches on the instance's
own CUDA stream, packs the results into one ``[B, 3, R, C]`` float32 tensor
(``u``, ``v``, invalid) and copies it with ``non_blocking=True`` into a
pinned host buffer, with at most two batches issued and not yet drained; a
drainer thread waits for each copy and fans the host tail over a pool.

With ``mesh=`` the engine runs as a ``parallel.ShardedPIV`` over the mesh:
batches stay in pinned host memory and ``ShardedPIV`` places each shard's
slice on its device; the packed results land on the mesh's first device,
from which the feeder copies them to the host as without a mesh.
"""
from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Generator, Optional, Tuple

import numpy as np
import torch

from .config import PIVConfig
from .io.dataset import PIVDataset, compute_background
from .io.decode import imread_gray
from .io.prefetch import PairPrefetcher
from .io.preprocess import PreprocessedPairs, resolve_preprocess
from .models.multipass import MultipassPIV
from .ops.infill import fill_missing_values, interpolate_borders
from .parallel.sharded import ShardedPIV
from .utils.device import resolve_device

log = logging.getLogger("torchpiv_tpu_torch")

# pinned [B, 3, R, C] result buffers a call keeps on CUDA: one being written
# by the feeder, two issued and not yet drained, one in the drainer
HOST_BUFFERS = 4


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
    ``skip_pairs``/``max_pairs``, ``background`` (``"none"``, ``"auto"``: the
    temporal minimum of the first pairs, or a ``[H, W]`` array taken as
    uint8; subtracted with saturation before the engine), ``preprocess``
    (``"none"``, ``"clahe"``, ``"stretch"`` or a frame -> frame callable, run
    in the decode threads), and any ``PIVConfig`` field via
    ``engine_options``.  ``engine_options`` also takes ``frame_mask`` (a
    ``[H, W]`` bool array, True = excluded, or the path of a mask image) and
    ``mask_threshold``: masked windows come out with zero displacement.
    ``device`` defaults to the CUDA card.

    ``mesh`` (a ``parallel.mesh.Mesh``) runs the engine as ``ShardedPIV``
    over it, as the JAX ``OfflinePIV(mesh=)`` does: the engine is built on
    the mesh's first device (``device`` is not used), ``batch_size`` is
    rounded up to a multiple of the pairs axis, every batch (the first one
    too) is a full batch, a short last batch is padded by repeating its last
    pair (the padded fields are dropped), and batches stay in pinned host
    memory until ``ShardedPIV`` places them.  ``background`` is subtracted
    on the host, in place, with the same saturation, by the decode workers.  The spans and the
    transfer log are kept as without a mesh; ``h2d_ms`` is None, since the
    shards' copies are part of the engine call.

    Two attributes, None by default, switch on accounting that changes no
    result; set them to a list before calling the instance:

    * ``transfer_log``: each batch placed on the device appends
      ``(t_start, t_end, n_bytes)`` (``io.prefetch.PairPrefetcher``);
    * ``span_log``: each drained batch appends a dict of its host spans:
      ``pairs``; ``decode_s`` and ``pin_s`` (decode and pinned staging, on a
      decode thread); ``h2d_ms`` (CUDA events around the copies on the
      prefetch stream); ``load_s`` (the feeder waiting for the batch from
      the prefetcher); ``issue_s`` (host clock around the background
      subtract and the engine call on the feeder); ``device_ms`` (CUDA events around the engine on the
      feeder's stream) and ``d2h_ms`` (around the result's copy);
      ``wait_s`` (the drainer blocked on that copy); ``tail_s`` (the
      ``finalize_fields`` fan-out, until every field of the batch is
      handed to the caller's queue); ``first_field_t`` (``time.perf_counter``
      when the batch's first field was yielded; None if every pair of it
      was skipped).  The CUDA event spans are None on the CPU.
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
        mesh=None,
        background="none",
        preprocess="none",
        engine_options: Optional[dict] = None,
    ) -> None:
        engine_options = dict(engine_options or {})
        frame_mask = resolve_frame_mask(engine_options.pop("frame_mask", None))
        mask_threshold = engine_options.pop("mask_threshold", 0.5)
        self._dt = dt
        self._scale = scale
        self._batch = max(1, batch_size)
        # a small first batch: the first field arrives sooner
        self._first_batch = min(4, self._batch)
        self._mesh = mesh
        self._sharded: Optional[ShardedPIV] = None
        self._device = (mesh.device_list[0] if mesh is not None
                        else resolve_device(device))
        self._decode_threads = decode_threads
        self._dataset = PIVDataset(folder, file_fmt, folder_mode)
        if skip_pairs:  # resume support: pairs are consumed in sorted order
            self._dataset.img_pairs = self._dataset.img_pairs[skip_pairs:]
        if max_pairs is not None:
            self._dataset.img_pairs = self._dataset.img_pairs[:max_pairs]
        # frame conditioning runs in the prefetcher's decode threads; the
        # background estimate and the engine see the conditioned frames
        pp = resolve_preprocess(preprocess)
        if pp is not None:
            self._dataset = PreprocessedPairs(self._dataset, pp)
        if isinstance(background, str):
            if background == "auto":
                background = compute_background(self._dataset)
            elif background == "none":
                background = None
            else:
                raise ValueError(f"unknown background option {background!r}")
        else:
            background = np.asarray(background, dtype=np.uint8)
        self._background: Optional[torch.Tensor] = None
        if background is not None:  # on the device once (on the host: mesh)
            self._background = torch.from_numpy(background)
            if mesh is None:
                self._background = self._background.to(self._device)
        self.transfer_log: Optional[list] = None
        self.span_log: Optional[list] = None
        # the feeder's stream and the prefetcher's copy stream, made at the
        # first call and kept: the caching allocator keeps freed device
        # blocks per stream, so streams made anew for every call would start
        # each call without cached blocks (cudaMalloc on the first batches)
        self._streams: Optional[Tuple[torch.cuda.Stream, torch.cuda.Stream]] = None
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
        if mesh is not None and self._engine is not None:
            self._sharded = ShardedPIV(self._engine, mesh)
            npairs = mesh.shape[self._sharded.pair_axis]
            self._batch = -(-self._batch // npairs) * npairs
            # uniform batches: each one divides the pairs axis
            self._first_batch = self._batch

    @property
    def engine(self) -> Optional[MultipassPIV]:
        return self._engine

    def __len__(self) -> int:
        return len(self._dataset)

    def __call__(self) -> Generator:
        """Three stages, each on its own thread(s), as in the JAX
        ``OfflinePIV``:

        * prefetcher threads: disk -> decode -> pinned staging -> async H2D;
        * feeder thread (``piv-feeder``): background, engine and the async
          D2H of the packed results into pinned buffers, on the instance's
          own CUDA stream, with at most two batches issued and not yet
          drained;
        * drainer thread (``piv-drainer``): waits for each batch's copy and
          fans ``finalize_fields`` over a pool.

        Fields come out in sorted pair order; errors of either thread are
        raised here; closing the generator early stops and joins both.
        """
        if self._engine is None:
            return
        engine = self._engine
        sharded = self._sharded
        dev = self._device
        cuda = dev.type == "cuda"
        bg = self._background
        x, y = engine.final_coordinates
        # the host NaN + infill tail runs only for infill="host": "fused"
        # is filled on the device already, "none" asks for raw vectors
        tail_validates = engine.config.validate and engine.config.infill == "host"
        static_mask = engine.window_masked[-1]
        if static_mask is not None:
            static_mask = static_mask.cpu().numpy()
        span_log = self.span_log
        timing = span_log is not None
        if cuda and self._streams is None:
            self._streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
        feed, copies = self._streams if cuda else (None, None)
        prefetch = PairPrefetcher(
            # with a mesh the batches stay on the host, pinned for the
            # shards' asynchronous copies
            self._dataset, self._batch, dev if sharded is None else torch.device("cpu"),
            num_threads=self._decode_threads,
            # three batches in flight keep the copies fed across the seams
            depth=3, first_batch_size=self._first_batch,
            transfer_log=self.transfer_log, spans=timing,
            stream=copies if sharded is None else None,
            pinned=sharded is not None and cuda,
            # with a mesh the decode workers subtract the background
            background=None if sharded is None else bg)

        stop = threading.Event()
        DONE = object()
        # two issued-but-undrained batches bound device memory and give the
        # drainer a full batch of lead time
        pending_q: "queue.Queue" = queue.Queue(maxsize=2)
        result_q: "queue.Queue" = queue.Queue(maxsize=4 * self._batch)
        free_q: "queue.Queue" = queue.Queue()  # pinned result buffers
        errors: list = []
        if cuda:
            for _ in range(HOST_BUFFERS):
                free_q.put(torch.empty((self._batch, 3, *engine.final_field_shape),
                                       dtype=torch.float32, pin_memory=True))

        def put_interruptible(q, item):
            """Bounded put that gives up when the pipeline is tearing down;
            returns False if dropped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def put_final(q, item):
            """Deliver a sentinel however long the consumer stalls; while
            tearing down (stop set: an error or an early close) evict to
            make room."""
            while True:
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    if stop.is_set():
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass

        def take_buffer():
            """A free pinned buffer, or None when tearing down."""
            while not stop.is_set():
                try:
                    return free_q.get(timeout=0.1)
                except queue.Empty:
                    continue
            return None

        def mesh_forward(batch_a, batch_b):
            """Host batches through ``ShardedPIV``, a short batch padded by
            repeating its last pair."""
            n = len(batch_a)
            if n < self._batch:
                batch_a, batch_b = (torch.cat([t, t[-1:].expand(self._batch - n, -1, -1)])
                                    for t in (batch_a, batch_b))
                if cuda:
                    batch_a, batch_b = batch_a.pin_memory(), batch_b.pin_memory()
            return sharded.packed(batch_a, batch_b)[:n]

        def issue(batch_a, batch_b, ids, span, load_s):
            """The engine over one batch and the copy of its results; returns
            the drainer's item, or None when tearing down."""
            marks = None
            if timing and cuda:
                marks = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                marks[0].record()
            t0 = time.perf_counter()
            if sharded is not None:
                packed = mesh_forward(batch_a, batch_b)
            else:
                if bg is not None:  # saturating background subtract
                    batch_a = torch.where(batch_a > bg, batch_a - bg, 0)
                    batch_b = torch.where(batch_b > bg, batch_b - bg, 0)
                packed = packed_forward(engine, batch_a, batch_b)
            issue_s = time.perf_counter() - t0
            if not cuda:  # the result is host memory already
                return ids, packed, None, None, (span, marks, load_s, issue_s)
            if marks is not None:
                marks[1].record()
            buf = take_buffer()
            if buf is None:
                return None
            host = buf[:len(ids)]
            host.copy_(packed, non_blocking=True)
            copied = torch.cuda.Event(enable_timing=timing)
            copied.record()
            # `packed` is freed on return, on the stream that made it
            return ids, host, buf, copied, (span, marks, load_s, issue_s)

        def feeder():
            try:
                with (torch.cuda.device(dev) if cuda else contextlib.nullcontext()), \
                        (torch.cuda.stream(feed) if cuda else contextlib.nullcontext()):
                    load_t = time.perf_counter()
                    for batch_a, batch_b, ids, span in prefetch.batches():
                        if stop.is_set():
                            break
                        start = time.perf_counter()
                        log.info("load time %.3f s", start - load_t)
                        item = issue(batch_a, batch_b, ids, span, start - load_t)
                        if item is None or not put_interruptible(pending_q, item):
                            break
                        load_t = time.perf_counter()
            except BaseException as e:  # noqa: BLE001 - forwarded to caller
                errors.append(e)
                stop.set()
            finally:
                put_final(pending_q, DONE)

        def spans_of(n, stats, copied, wait_s):
            """A drained batch's spans (see the class docstring)."""
            pre, marks, load_s, issue_s = stats
            h2d = pre.pop("h2d")
            return {**pre, "pairs": n,
                    "h2d_ms": h2d[0].elapsed_time(h2d[1]) if h2d else None,
                    "load_s": load_s, "issue_s": issue_s,
                    "device_ms": marks[0].elapsed_time(marks[1]) if marks else None,
                    "d2h_ms": marks[1].elapsed_time(copied) if marks else None,
                    "wait_s": wait_s, "tail_s": None, "first_field_t": None}

        def drainer():
            try:
                with ThreadPoolExecutor(
                    max_workers=max(2, self._decode_threads)
                ) as pool:
                    while True:
                        item = pending_q.get()
                        if item is DONE:
                            break
                        if stop.is_set():
                            continue  # discard; keep consuming until DONE
                        ids, host, buf, copied, stats = item
                        t0 = time.perf_counter()
                        if copied is not None:
                            copied.synchronize()  # this batch's D2H copy
                        t_wait = time.perf_counter()
                        arr = host.numpy()
                        u_b, v_b = arr[:, 0], arr[:, 1]
                        inval_b = arr[:, 2] > 0.5
                        futs = [
                            pool.submit(
                                finalize_fields, u_b[i], v_b[i],
                                inval_b[i] if tail_validates else None,
                                x, y, self._scale, self._dt, static_mask)
                            for i in range(len(ids))
                        ]
                        span = None
                        if timing:
                            span = spans_of(len(ids), stats, copied, t_wait - t0)
                            span_log.append(span)
                        first = span  # goes with the batch's first field
                        for pid, fut in zip(ids, futs):
                            res = fut.result()
                            if res is None:
                                log.warning(
                                    "pair %d skipped: too many invalid "
                                    "vectors", pid)
                                continue
                            if not put_interruptible(result_q, (first, res)):
                                break
                            first = None
                        # the pool's tasks read the buffer until they return
                        wait(futs)
                        if span is not None:
                            span["tail_s"] = time.perf_counter() - t_wait
                        if buf is not None:
                            free_q.put(buf)
                        log.info("batch of %d drained in %.3f s",
                                 len(ids), time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001 - forwarded to caller
                errors.append(e)
                stop.set()
            finally:
                put_final(result_q, DONE)

        feeder_t = threading.Thread(target=feeder, name="piv-feeder", daemon=True)
        drainer_t = threading.Thread(target=drainer, name="piv-drainer", daemon=True)
        feeder_t.start()
        drainer_t.start()
        try:
            while True:
                item = result_q.get()
                if item is DONE:
                    break
                span, res = item
                if span is not None:
                    span["first_field_t"] = time.perf_counter()
                yield res
            if errors:
                raise errors[0]
        finally:
            stop.set()
            feeder_t.join(timeout=30)
            drainer_t.join(timeout=30)
