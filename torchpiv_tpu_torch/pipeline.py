"""Pipeline layer: ``OfflinePIV``, the streaming front ends ``OnlinePIV``
and ``VideoPIV``, the headless ``PIVRunner``, ``DeviceMap`` and the
per-pair host tail (counterpart of ``torchpiv_tpu/pipeline.py``).

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

``OnlinePIV``, ``VideoPIV`` and the HTTP service (``serve.py``) run the
engine on the calling thread through ``run_packed``, which enters the
engine's CUDA device itself: a thread other than the main one (an HTTP
handler, a GUI worker) would otherwise launch on device 0.  The JAX
package's compile futures, ahead-of-time executables and fixed-shape batch
padding are TPU workarounds and have no counterpart: a batch of any size
runs the same kernels, which are built at their first use.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Dict, Generator, Optional, Tuple

import numpy as np
import torch

from .config import PIVConfig
from .io.dataset import PIVDataset, compute_background
from .io.decode import imread_gray
from .io.prefetch import PairPrefetcher
from .io.preprocess import PreprocessedPairs, resolve_preprocess
from .io.watch import StreamingPairSource
from .models.multipass import MultipassPIV
from .ops.infill import fill_missing_values, interpolate_borders
from .parallel.sharded import ShardedPIV
from .stats.ensemble import EnsembleAccumulator
from .utils import profiling
from .utils.config import PIVParams
from .utils.device import resolve_device
from .utils.persistence import save_binary, save_table

log = logging.getLogger("torchpiv_tpu_torch")

# pinned [B, 3, R, C] result buffers a call keeps on CUDA: one being written
# by the feeder, two issued and not yet drained, one in the drainer
HOST_BUFFERS = 4


class DeviceMap:
    """Device name -> ``torch.device``: the JAX package's ``DeviceMap`` on
    top of ``utils.device.resolve_device``, whose names it takes
    (``"auto"``, ``"cpu"``, ``"cuda"``, ``"cuda:<i>"``; ``"tpu"`` raises
    ``ValueError``, a CUDA name without a card ``RuntimeError``)."""

    @staticmethod
    def devices() -> Dict[str, torch.device]:
        table = {"cpu": torch.device("cpu")}
        if torch.cuda.is_available():
            table["cuda"] = torch.device("cuda", torch.cuda.current_device())
            for i in range(torch.cuda.device_count()):
                table[f"cuda:{i}"] = torch.device("cuda", i)
        return table

    resolve = staticmethod(resolve_device)


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


def tail_of(engine: MultipassPIV, scale: float, dt: float) -> Callable:
    """The host tail of ``OfflinePIV`` for ``engine``'s fields: a function
    of one pair's raw ``(u, v, invalid)`` host arrays that returns its
    ``(x, y, u, v)``, or None when the pair is skipped.  The NaN + infill
    tail runs only for ``infill="host"`` with validation: ``"fused"`` is
    filled on the device already, ``"none"`` asks for raw vectors."""
    x, y = engine.final_coordinates
    validates = engine.config.validate and engine.config.infill == "host"
    static_mask = engine.window_masked[-1]
    if static_mask is not None:
        static_mask = static_mask.cpu().numpy()

    def tail(u, v, invalid):
        return finalize_fields(u, v, invalid if validates else None,
                               x, y, scale, dt, static_mask)

    return tail


def run_packed(engine: MultipassPIV, frames_a, frames_b) -> np.ndarray:
    """The engine over numpy ``[B, H, W]`` frame stacks (or sequences of
    ``[H, W]`` frames) on its device; returns the packed ``[B, 3, R, C]``
    fields on the host.  The calling thread enters the engine's CUDA
    device for the call."""
    dev = engine.device
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        a = torch.from_numpy(np.stack(frames_a)).to(dev)
        b = torch.from_numpy(np.stack(frames_b)).to(dev)
        return packed_forward(engine, a, b).cpu().numpy()


def fields_of(tail: Callable, packed: np.ndarray) -> Generator:
    """``tail`` over each pair of a packed ``[B, 3, R, C]`` host array: the
    fields of the pairs that are not skipped, in order."""
    for p in packed:
        res = tail(p[0], p[1], p[2] > 0.5)
        if res is not None:
            yield res


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
      ``(t_start, t_end, n_bytes)`` (``io.prefetch.PairPrefetcher``), on
      ``time.perf_counter``;
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
      was skipped); ``call`` (the id of the engine call's record in
      ``utils.profiling.calls()``, None unless ``torch.profiler`` was
      active).  The CUDA event spans are None on the CPU.

    Clocks: the ``_s`` spans and ``first_field_t`` are ``time.perf_counter``
    on the thread named; the ``_ms`` spans are CUDA events, device time;
    the engine call's record takes ``time.time_ns()``, the profiler's
    clock, with CUDA events on the feeder's stream.
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
        tail = tail_of(engine, self._scale, self._dt)
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
            call = None
            if sharded is not None:
                packed = mesh_forward(batch_a, batch_b)
            else:
                if bg is not None:  # saturating background subtract
                    batch_a = torch.where(batch_a > bg, batch_a - bg, 0)
                    batch_b = torch.where(batch_b > bg, batch_b - bg, 0)
                packed = packed_forward(engine, batch_a, batch_b)
                call = profiling.last_call()
            issue_s = time.perf_counter() - t0
            stats = (span, marks, load_s, issue_s, call)
            if not cuda:  # the result is host memory already
                return ids, packed, None, None, stats
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
            return ids, host, buf, copied, stats

        def feeder():
            try:
                with (torch.cuda.device(dev) if cuda else contextlib.nullcontext()), \
                        (torch.cuda.stream(feed) if cuda else contextlib.nullcontext()):
                    load_t = time.perf_counter()
                    for batch_a, batch_b, ids, span in prefetch.batches():
                        if stop.is_set():
                            break
                        start = time.perf_counter()
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
            pre, marks, load_s, issue_s, call = stats
            h2d = pre.pop("h2d")
            return {**pre, "pairs": n, "call": call,
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
                        futs = [pool.submit(tail, u_b[i], v_b[i], inval_b[i])
                                for i in range(len(ids))]
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


class OnlinePIV:
    """Streaming PIV: process pairs as a camera writes them into ``folder``.

    Iterating yields ``(x, y, u, v)`` per new pair (only files that appear
    after construction count); call ``stop()`` (or let ``idle_timeout``
    expire) to end the stream.

    Dispatch: one engine call a pair while the stream keeps up; when a
    backlog builds (the camera writes faster than a call takes), pairs are
    drained in ``catchup_batch``-pair calls, which spread the fixed cost of
    a call.  ``catchup_batch=1`` turns batching off.

    ``frame_shape`` (the camera geometry, e.g. ``(2048, 2048)``) builds the
    engine when the stream starts, before its first frame, and runs one
    warm call of each size on blank frames of that shape: the first pair
    then pays neither the kernels' build nor cuFFT's plans.  Frames whose
    shape differs from the engine's are skipped with a warning.

    ``engine_options`` takes any ``PIVConfig`` field, ``frame_mask`` and
    ``mask_threshold``, as ``OfflinePIV``'s does.  ``dispatches`` counts the
    engine calls by kind: ``"warm"``, ``"single"`` and ``"catchup"`` (each
    catch-up call runs ``catchup_batch`` pairs).
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
        *,
        validate: bool = True,
        poll_interval: float = 0.2,
        idle_timeout: Optional[float] = None,
        catchup_batch: int = 4,
        preprocess="none",
        frame_shape: Optional[Tuple[int, int]] = None,
        engine_options: Optional[dict] = None,
    ) -> None:
        self._dt = dt
        self._scale = scale
        self._preprocess = resolve_preprocess(preprocess)
        self._device = DeviceMap.resolve(device)
        self._source = StreamingPairSource(folder, file_fmt, poll_interval,
                                           idle_timeout)
        self._catchup = max(1, catchup_batch)
        engine_options = dict(engine_options or {})
        self._frame_mask = resolve_frame_mask(engine_options.pop("frame_mask", None))
        self._mask_threshold = engine_options.pop("mask_threshold", 0.5)
        self._engine_kwargs = dict(
            wind_size=wind_size,
            overlap=overlap,
            multipass=multipass,
            multipass_mode=multipass_mode,
            multipass_scale=multipass_scale,
            validate=validate,
            **engine_options,
        )
        self._engine: Optional[MultipassPIV] = None
        self._tail: Optional[Callable] = None
        self._frame_shape = (tuple(frame_shape)
                             if frame_shape is not None else None)
        self.dispatches: collections.Counter = collections.Counter()

    @property
    def engine(self) -> Optional[MultipassPIV]:
        return self._engine

    def stop(self) -> None:
        self._source.stop()

    def _decode(self, name_a, name_b):
        # A live camera writes files while the watcher polls, so a frame
        # can be listed before its bytes are complete; a one-shot read
        # would drop the pair for good.  Retry briefly: a mid-write file
        # becomes readable milliseconds later, and a corrupt one still
        # skips after about 0.3 s.
        frame_a = frame_b = None
        for attempt in range(3):
            if attempt:
                time.sleep(0.05 * attempt)
            if frame_a is None:
                frame_a = imread_gray(name_a)
            if frame_b is None:
                frame_b = imread_gray(name_b)
            if frame_a is not None and frame_b is not None:
                break
        else:
            log.warning("online: skipping unreadable pair %s / %s",
                        name_a, name_b)
            return None
        if self._preprocess is not None:
            frame_a = self._preprocess(frame_a)
            frame_b = self._preprocess(frame_b)
        return frame_a, frame_b

    def _ensure_engine(self, frame_shape) -> None:
        if self._engine is not None:
            return
        cfg = PIVConfig(frame_shape=tuple(frame_shape), **self._engine_kwargs)
        self._engine = MultipassPIV(cfg, device=self._device,
                                    frame_mask=self._frame_mask,
                                    mask_threshold=self._mask_threshold)
        self._tail = tail_of(self._engine, self._scale, self._dt)

    def _dispatch(self, pairs, kind: str) -> np.ndarray:
        """The engine over ``pairs`` (``(frame_a, frame_b)`` each): packed
        ``[B, 3, R, C]`` fields on the host."""
        arr = run_packed(self._engine, [p[0] for p in pairs],
                         [p[1] for p in pairs])
        self.dispatches[kind] += 1
        return arr

    def __call__(self) -> Generator:
        B = self._catchup
        if self._frame_shape is not None and self._engine is None:
            # frames that land meanwhile are new to the first poll: the
            # watcher listed the folder at construction
            self._ensure_engine(self._frame_shape)
            blank = np.zeros(self._frame_shape, np.uint8)
            for n in sorted({1, B}):
                self._dispatch([(blank, blank)] * n, "warm")
        backlog: list = []
        for burst in self._source.bursts():
            for name_a, name_b in burst:
                pair = self._decode(name_a, name_b)
                if pair is None:
                    continue
                if self._engine is None:
                    self._ensure_engine(pair[0].shape)
                if pair[0].shape == self._engine.config.frame_shape:
                    backlog.append(pair)
                else:
                    log.warning(
                        "online: skipping %s: frame shape %s != engine %s",
                        name_a, pair[0].shape, self._engine.config.frame_shape)
            while len(backlog) >= B > 1:
                chunk, backlog = backlog[:B], backlog[B:]
                yield from fields_of(self._tail, self._dispatch(chunk, "catchup"))
            while backlog:
                yield from fields_of(self._tail, self._dispatch([backlog.pop(0)], "single"))


class VideoPIV:
    """PIV over a video file's frame stream (the reference's "PIV Video
    File" menu intent).  Same generator contract as ``OfflinePIV``: yields
    ``(x, y, u, v)`` per frame pair, ``batch_size`` pairs an engine call;
    the last batch may be short (the JAX package pads it to its compiled
    shape, a TPU workaround the port does not need)."""

    def __init__(
        self,
        path: str,
        device: str = "auto",
        wind_size: int = 64,
        overlap: int = 32,
        multipass: int = 1,
        multipass_mode: str = "CWS",
        dt: float = 1,
        scale: float = 1.0,
        multipass_scale: float = 2.0,
        folder_mode: str = "sequential",
        *,
        batch_size: int = 4,
        validate: bool = True,
        max_pairs: Optional[int] = None,
        preprocess="none",
        engine_options: Optional[dict] = None,
    ) -> None:
        from .io.video import VideoPairSource

        self._batch = max(1, batch_size)
        device = DeviceMap.resolve(device)
        self._source = VideoPairSource(path, folder_mode, max_pairs)
        self._preprocess = resolve_preprocess(preprocess)
        engine_options = dict(engine_options or {})
        frame_mask = resolve_frame_mask(engine_options.pop("frame_mask", None))
        mask_threshold = engine_options.pop("mask_threshold", 0.5)
        cfg = PIVConfig(
            frame_shape=self._source.frame_shape,
            wind_size=wind_size,
            overlap=overlap,
            multipass=multipass,
            multipass_mode=multipass_mode,
            multipass_scale=multipass_scale,
            validate=validate,
            **engine_options,
        )
        self._engine = MultipassPIV(cfg, device=device, frame_mask=frame_mask,
                                    mask_threshold=mask_threshold)
        self._tail = tail_of(self._engine, scale, dt)

    @property
    def engine(self) -> MultipassPIV:
        return self._engine

    def __len__(self) -> int:
        return len(self._source)

    def __call__(self) -> Generator:
        def flush(batch):
            return fields_of(self._tail, run_packed(
                self._engine, [a for a, _ in batch], [b for _, b in batch]))

        batch = []
        for pair in self._source:
            if self._preprocess is not None:
                pair = (self._preprocess(pair[0]), self._preprocess(pair[1]))
            batch.append(pair)
            if len(batch) == self._batch:
                yield from flush(batch)
                batch = []
        if batch:
            yield from flush(batch)


class _AsyncSaver:
    """Per-pair saves on a writer thread with a bounded queue (copy of the
    JAX package's): a synchronous text save a pair would be the pipeline's
    bottleneck, so writes overlap with compute and push back only when the
    disk cannot keep up.  Errors surface on the next submit or close."""

    def __init__(self, maxsize: int = 8):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(
            target=self._run, name="piv-saver", daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except BaseException as e:  # surfaced at next submit/close
                self._err = e

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, fn, *args) -> None:
        self._check()
        self._q.put((fn, args))

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        self._check()


class PIVRunner:
    """Headless equivalent of the reference's Qt ``PIVWorker``: drives
    ``OfflinePIV``, reports progress through plain callbacks, supports
    cooperative pause and stop, optional per-pair saving, and emits the
    13-column statistics table at the end (counterpart of the JAX
    package's ``PIVRunner``; nothing here imports Qt).

    ``smooth``: robust smoothn post-smoothing of each field
    (``stats.smoothing``), True = the GCV-chosen parameter a pair, a float
    = that parameter.  ``checkpoint_path`` saves the statistics state every
    ``checkpoint_every`` pairs and on stop, resumes from it, and is removed
    when the run completes.  ``shard=(index, count)`` processes only that
    contiguous block of pairs (``parallel.distributed.pair_block``) and
    keeps its final state at ``checkpoint_path``, marked complete, for
    ``parallel.merge_checkpoints``.  Other keywords go to ``OfflinePIV``.
    """

    def __init__(
        self,
        params: PIVParams,
        on_progress: Optional[Callable[[int], None]] = None,
        on_output: Optional[Callable[[Dict[str, np.ndarray]], None]] = None,
        on_finished: Optional[Callable[[Dict[str, np.ndarray]], None]] = None,
        on_failed: Optional[Callable[[], None]] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 50,
        smooth: bool | float = False,
        shard: Optional[Tuple[int, int]] = None,
        **offline_kwargs,
    ):
        self.params = params
        self.on_progress = on_progress or (lambda pct: None)
        self.on_output = on_output or (lambda out: None)
        self.on_finished = on_finished or (lambda table: None)
        self.on_failed = on_failed or (lambda: None)
        self.is_paused = False
        self.is_running = True
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.smooth = smooth
        self.shard = shard
        self._offline_kwargs = offline_kwargs

    def stop(self) -> None:
        self.is_running = False

    def pause(self, flag: bool = True) -> None:
        self.is_paused = flag

    def run(self) -> Optional[Dict[str, np.ndarray]]:
        from .utils.checkpoint import load_checkpoint, save_checkpoint

        p = self.params
        acc = EnsembleAccumulator()
        x = y = None
        skip = 0
        if self.checkpoint_path:
            state = load_checkpoint(self.checkpoint_path)
            if state is not None:
                acc, skip, x, y = state
                log.info("resuming from checkpoint: %d pairs done", skip)
        shard_start, shard_count = 0, None
        if self.shard is not None:
            from .parallel.distributed import pair_block

            si, sn = self.shard
            n_all = len(PIVDataset(p.folder, p.file_fmt, p.folder_mode))
            shard_start, shard_count = pair_block(n_all, si, sn)
            log.info("shard %d/%d: pairs [%d, %d)", si, sn,
                     shard_start, shard_start + shard_count)
        piv_gen = OfflinePIV(
            folder=p.folder,
            device=p.device,
            file_fmt=p.file_fmt,
            wind_size=p.wind_size,
            overlap=p.overlap,
            multipass=p.multipass,
            multipass_mode=p.multipass_mode,
            dt=p.dt,
            scale=p.scale,
            multipass_scale=p.multipass_scale,
            folder_mode=p.folder_mode,
            skip_pairs=shard_start + skip,
            max_pairs=(None if shard_count is None
                       else max(0, shard_count - skip)),
            **self._offline_kwargs,
        )
        total = len(piv_gen) + skip
        if total == 0:
            self.on_failed()
            return None

        name = os.path.basename(os.path.normpath(p.folder))
        start = time.perf_counter()
        done = skip
        saver = (_AsyncSaver()
                 if p.save_opt in ("Save all binary", "Save all text")
                 else None)
        # statically masked windows (ROI) are zero by contract: the
        # smoother leaves them out and keeps them at zero; yielded fields
        # are row-flipped, so is the mask
        wm = None
        if self.smooth and piv_gen.engine is not None \
                and piv_gen.engine.window_masked[-1] is not None:
            wm = np.flip(piv_gen.engine.window_masked[-1].cpu().numpy(), axis=0)
        for x, y, u, v in piv_gen():
            while self.is_paused and self.is_running:
                time.sleep(0.02)
            if not self.is_running:
                break
            if self.smooth:
                from .stats.smoothing import smooth_vector_field

                s = None if self.smooth is True else float(self.smooth)
                u, v = smooth_vector_field(u, v, mask=wm, s=s, robust=True)
                if wm is not None:
                    u[wm] = 0.0
                    v[wm] = 0.0
            acc.add(u, v)
            done += 1
            self.on_progress(int(done / total * 100))
            output = {"x[mm]": x, "y[mm]": y, "Vx[m/s]": u, "Vy[m/s]": v}
            # per-pair saves overlap with compute on the writer thread (the
            # yielded arrays are not changed after this point); the single
            # writer keeps the files in pair order
            if p.save_opt == "Save all binary":
                saver.submit(save_binary, f"{name}_pair.npy", p.save_dir,
                             dict(output))
            elif p.save_opt == "Save all text":
                saver.submit(save_table, f"{name}_pair.txt", p.save_dir,
                             dict(output))
            self.on_output(output)
            if (
                self.checkpoint_path
                and self.checkpoint_every
                and done % self.checkpoint_every == 0
            ):
                save_checkpoint(self.checkpoint_path, acc, done, x, y)

        if saver is not None:
            saver.close()  # drain pending writes; re-raise any save error
        if acc.n == 0:
            self.on_failed()
            return None
        if self.checkpoint_path and self.is_running is False:
            # interrupted: keep the progress for a resume
            save_checkpoint(self.checkpoint_path, acc, done, x, y)
        log.info("avg PIV time %.0f ms",
                 (time.perf_counter() - start) / acc.n * 1000)
        table = acc.finalize(x, y)
        if p.save_opt != "Dont save":
            save_table(f"{name}_statistics.txt", p.save_dir, dict(table))
        if self.checkpoint_path and self.is_running:
            if self.shard is not None:
                # shard mode: the final state is the product, merged later;
                # complete=True tells it from an interrupted shard's
                save_checkpoint(self.checkpoint_path, acc, done, x, y,
                                complete=True)
            elif os.path.exists(self.checkpoint_path):
                os.remove(self.checkpoint_path)  # completed: no resume state
        self.on_finished(table)
        return table
