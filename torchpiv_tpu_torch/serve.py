"""HTTP serving mode: a long-lived PIV analysis service (counterpart of
``torchpiv_tpu/serve.py``, with the same endpoints and wire format, so
either package's ``PIVClient`` talks to either package's server).

Acquisition machines that share one accelerator host submit frame pairs
(or point the server at files it can read) and get fields back, with the
engine built once per frame shape and kept across requests.

Endpoints (all responses JSON unless noted):

* ``GET /healthz``: liveness, device and the frame shapes with an engine
  (``compiled_shapes``, the JAX package's key).
* ``GET /config``: the analysis settings the server applies.
* ``GET /metrics``: Prometheus-style text: pairs served, error count,
  rolling latency.
* ``POST /piv``: body an ``.npz`` with uint8 arrays ``a`` and ``b`` (same
  shape).  Response: an ``.npz`` with ``x, y, u, v`` (physical units, the
  ``OfflinePIV`` contract) and the ``invalid`` mask.  A camera burst may be
  submitted as stacked ``[B, H, W]`` arrays: the response fields gain the
  leading pair axis plus a ``skipped_pairs`` mask (a pair with more than
  half of its vectors invalid comes back as NaN planes rather than failing
  the burst).
* ``POST /piv_files``: body JSON ``{"a": path, "b": path}`` naming files
  the server can read (a shared filesystem); same ``.npz`` response.

Transport is the standard library's threading HTTP server.  Engine builds
and calls are serialised by one lock; each handler thread enters the
engine's CUDA device itself (``pipeline.run_packed``).  A burst runs in
``TPIV_SERVE_SCAN_B``-pair engine calls (8 by default, the JAX package's
variable); the last call takes what is left, without the JAX package's
padding to a compiled shape.
"""
from __future__ import annotations

import io
import json
import logging
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .config import PIVConfig
from .io.decode import imread_gray
from .models.multipass import MultipassPIV
from .pipeline import DeviceMap, run_packed, tail_of

log = logging.getLogger("torchpiv_tpu_torch")


class PIVService:
    """Engine state shared across requests: one engine per frame shape
    (built at the first request for it, or by ``warmup``), the
    physical-unit tail, and rolling metrics.  ``engine_options`` takes any
    ``PIVConfig`` field."""

    def __init__(
        self,
        device: str = "auto",
        wind_size: int = 64,
        overlap: int = 32,
        multipass: int = 1,
        multipass_mode: str = "CWS",
        dt: float = 1.0,
        scale: float = 1.0,
        multipass_scale: float = 2.0,
        validate: bool = True,
        engine_options: Optional[dict] = None,
    ):
        self._device = DeviceMap.resolve(device)
        self._dt = dt
        self._scale = scale
        self._settings = dict(
            wind_size=wind_size,
            overlap=overlap,
            multipass=multipass,
            multipass_mode=multipass_mode,
            multipass_scale=multipass_scale,
            validate=validate,
            **(engine_options or {}),
        )
        # shape -> (engine, host tail)
        self._engines: Dict[Tuple[int, int], Tuple[MultipassPIV, Callable]] = {}
        self._scan_b = int(os.environ.get("TPIV_SERVE_SCAN_B", 8))
        self._lock = threading.Lock()  # engine build + dispatch
        # the counters are updated by the handler threads outside the
        # dispatch lock
        self._metrics_lock = threading.Lock()
        self.pairs_served = 0
        self.errors = 0
        self.latencies_ms: deque = deque(maxlen=256)
        self.started = time.time()

    # ---- engine -----------------------------------------------------------
    def _engine_for(self, shape: Tuple[int, int]):
        """``(engine, tail)`` for ``shape``; the caller holds the lock."""
        shape = tuple(int(s) for s in shape)
        entry = self._engines.get(shape)
        if entry is None:
            cfg = PIVConfig(frame_shape=shape, **self._settings)
            engine = MultipassPIV(cfg, device=self._device)
            entry = (engine, tail_of(engine, self._scale, self._dt))
            self._engines[shape] = entry
            log.info("serve: built the engine for frame shape %s", shape)
        return entry

    def warmup(self, shape: Tuple[int, int]) -> None:
        """Build the engine for ``shape`` and run both dispatch paths on
        blank frames before traffic arrives: one pair (``/piv`` with one
        pair, ``/piv_files``; counted as a pair served, as in the JAX
        package) and one burst call of ``TPIV_SERVE_SCAN_B`` pairs."""
        z = np.zeros(tuple(shape), np.uint8)
        # blank frames may come back skipped (more than half invalid):
        # what is warmed is the path, not the answer
        self.analyze(z, z)
        with self._lock:
            engine, _ = self._engine_for(shape)
            run_packed(engine, [z] * self._scan_b, [z] * self._scan_b)

    def _finalize_pair(self, tail, u, v, inval, t0) -> dict:
        """Host tail + metrics for one pair's raw device results."""
        res = tail(u, v, inval)
        with self._metrics_lock:
            self.latencies_ms.append(1000 * (time.perf_counter() - t0))
            self.pairs_served += 1
        if res is None:  # more than half invalid: the reference's skip
            return {"skipped": True,
                    "reason": "more than half the vectors are invalid"}
        rx, ry, ru, rv = res
        return {"skipped": False, "x": rx, "y": ry, "u": ru, "v": rv,
                "invalid": np.asarray(inval)}

    def analyze(self, frame_a: np.ndarray, frame_b: np.ndarray) -> dict:
        """One pair through the engine; returns the ``OfflinePIV``-contract
        fields in physical units."""
        if frame_a.shape != frame_b.shape or frame_a.ndim != 2:
            raise ValueError(
                f"expected two matching 2-D frames, got {frame_a.shape} "
                f"vs {frame_b.shape}")
        frame_a = np.asarray(frame_a, dtype=np.uint8)
        frame_b = np.asarray(frame_b, dtype=np.uint8)
        t0 = time.perf_counter()
        with self._lock:
            engine, tail = self._engine_for(frame_a.shape)
            arr = run_packed(engine, [frame_a], [frame_b])[0]
        return self._finalize_pair(tail, arr[0], arr[1], arr[2] > 0.5, t0)

    def analyze_batch(self, frames_a: np.ndarray,
                      frames_b: np.ndarray) -> dict:
        """A stacked burst ``[B, H, W]`` through the engine in
        ``TPIV_SERVE_SCAN_B``-pair calls.  A pair with more than half of its
        vectors invalid becomes NaN planes plus a ``skipped_pairs`` entry
        instead of failing the whole burst."""
        if (frames_a.shape != frames_b.shape or frames_a.ndim != 3
                or frames_a.shape[0] == 0):
            raise ValueError(
                f"expected two matching non-empty [B,H,W] stacks, got "
                f"{frames_a.shape} vs {frames_b.shape}")
        frames_a = np.asarray(frames_a, dtype=np.uint8)
        frames_b = np.asarray(frames_b, dtype=np.uint8)
        us, vs, invs, skipped = [], [], [], []
        x = y = None
        B = self._scan_b
        for start in range(0, frames_a.shape[0], B):
            chunk_a = frames_a[start:start + B]
            chunk_b = frames_b[start:start + B]
            t0 = time.perf_counter()
            with self._lock:
                engine, tail = self._engine_for(chunk_a.shape[1:])
                arr = run_packed(engine, chunk_a, chunk_b)
            for i in range(len(chunk_a)):
                res = self._finalize_pair(
                    tail, arr[i, 0], arr[i, 1], arr[i, 2] > 0.5, t0)
                skipped.append(res["skipped"])
                if res["skipped"]:
                    us.append(None)  # the shape is known from a kept pair
                    vs.append(None)
                    invs.append(None)
                else:
                    x, y = res["x"], res["y"]
                    us.append(res["u"])
                    vs.append(res["v"])
                    invs.append(res["invalid"])
        if x is None:  # every pair skipped
            return {"skipped": True,
                    "reason": "every pair in the burst was skipped "
                              "(more than half the vectors invalid)"}
        nan = np.full(x.shape, np.nan)
        allbad = np.ones(x.shape, bool)
        return {
            "skipped": False, "x": x, "y": y,
            "u": np.stack([u if u is not None else nan for u in us]),
            "v": np.stack([v if v is not None else nan for v in vs]),
            "invalid": np.stack(
                [i if i is not None else allbad for i in invs]),
            "skipped_pairs": np.asarray(skipped, bool),
        }

    def record_error(self) -> None:
        with self._metrics_lock:
            self.errors += 1

    # ---- views ------------------------------------------------------------
    def health(self) -> dict:
        return {
            "ok": True,
            "device": str(self._device),
            "compiled_shapes": sorted(list(s) for s in self._engines),
            "pairs_served": self.pairs_served,
            "uptime_s": round(time.time() - self.started, 1),
        }

    def config(self) -> dict:
        return {**self._settings, "dt": self._dt, "scale": self._scale,
                "device": str(self._device)}

    def metrics_text(self) -> str:
        lat = list(self.latencies_ms)
        lines = [
            "# TYPE tpiv_pairs_served counter",
            f"tpiv_pairs_served {self.pairs_served}",
            "# TYPE tpiv_errors counter",
            f"tpiv_errors {self.errors}",
            "# TYPE tpiv_latency_ms summary",
            f"tpiv_latency_ms_count {len(lat)}",
        ]
        if lat:
            lines += [
                f"tpiv_latency_ms_last {lat[-1]:.2f}",
                f"tpiv_latency_ms_median {float(np.median(lat)):.2f}",
                f"tpiv_latency_ms_p95 "
                f"{float(np.percentile(lat, 95)):.2f}",
            ]
        return "\n".join(lines) + "\n"


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    service: PIVService  # injected by make_server

    # no per-request stderr lines: route them to logging
    def log_message(self, fmt, *args):
        log.debug("serve: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802  (http.server API)
        if self.path == "/healthz":
            self._send_json(200, self.service.health())
        elif self.path == "/config":
            self._send_json(200, self.service.config())
        elif self.path == "/metrics":
            self._send(200, self.service.metrics_text().encode(),
                       "text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n)

    def do_POST(self):  # noqa: N802
        try:
            if self.path == "/piv":
                with np.load(io.BytesIO(self._read_body())) as z:
                    if "a" not in z.files or "b" not in z.files:
                        raise ValueError("npz must contain arrays 'a', 'b'")
                    fa, fb = z["a"], z["b"]
            elif self.path == "/piv_files":
                req = json.loads(self._read_body() or b"{}")
                fa = imread_gray(str(req.get("a", "")))
                fb = imread_gray(str(req.get("b", "")))
                if fa is None or fb is None:
                    raise ValueError(
                        f"unreadable file(s): {req.get('a')!r}, "
                        f"{req.get('b')!r}")
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})
                return
            if getattr(fa, "ndim", 2) == 3:  # stacked burst [B,H,W]
                res = self.service.analyze_batch(fa, fb)
            else:
                res = self.service.analyze(fa, fb)
            if res["skipped"]:
                self._send_json(422, {"error": res["reason"],
                                      "skipped": True})
                return
            extra = ({"skipped_pairs": res["skipped_pairs"]}
                     if "skipped_pairs" in res else {})
            self._send(200, _npz_bytes(
                x=res["x"], y=res["y"], u=res["u"], v=res["v"],
                invalid=res["invalid"], **extra), "application/octet-stream")
        except ValueError as e:
            self.service.record_error()
            self._send_json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - a server must not die
            self.service.record_error()
            log.exception("serve: request failed")
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(service: PIVService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``server.server_address``
    carries the bound port when ``port=0``."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def run_server(service: PIVService, host: str, port: int) -> None:
    srv = make_server(service, host, port)
    log.info("serve: listening on %s:%d", *srv.server_address)
    print(f"serve: listening on http://{srv.server_address[0]}:"
          f"{srv.server_address[1]}  (endpoints: /healthz /config /metrics "
          f"POST /piv POST /piv_files)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
