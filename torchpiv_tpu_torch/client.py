"""Client for the HTTP analysis service (copy of ``torchpiv_tpu/client.py``;
it speaks to the port's ``serve.py`` and to the JAX package's alike).

The acquisition-machine half of the serving mode (serve.py): a
dependency-free wrapper over ``urllib`` that submits frame pairs (or
camera bursts, or server-readable file paths) and returns numpy fields
in the ``OfflinePIV`` physical-unit contract.

    from torchpiv_tpu_torch.client import PIVClient
    c = PIVClient("http://gpu-host:8477")
    x, y, u, v, invalid = c.analyze(frame_a, frame_b)
    res = c.analyze_burst(stack_a, stack_b)   # dict with skipped_pairs
    c.health()["compiled_shapes"]

Raises :class:`PIVServerError` with the server's error message on 4xx/5xx
— except the single-pair >50 %-invalid skip (HTTP 422), which returns
``None`` like the ``OfflinePIV`` generator simply not yielding that pair.
"""
from __future__ import annotations

import io
import json
import urllib.error
import urllib.request
from typing import Optional, Tuple

import numpy as np


class PIVServerError(RuntimeError):
    """The server answered with an error status; ``.status`` holds it."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class PIVClient:
    def __init__(self, base_url: str, timeout: float = 600.0):
        # generous default timeout: the first request for a new frame
        # shape builds the engine server-side (and, on a fresh checkout,
        # its kernels)
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # ---- transport ---------------------------------------------------------
    def _request(self, path: str, body: Optional[bytes] = None,
                 ctype: str = "application/octet-stream"):
        req = urllib.request.Request(
            self.base_url + path, data=body,
            method="POST" if body is not None else "GET",
            headers={"Content-Type": ctype} if body is not None else {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    @staticmethod
    def _decode_response(status: int, data: bytes) -> Optional[dict]:
        """Shared /piv-endpoint response handling: 422 -> None (the
        >50 %-invalid skip quirk: pair not yielded), other errors ->
        PIVServerError with the server's JSON error message, 200 -> the
        npz payload as a dict."""
        if status == 422:
            return None
        if status != 200:
            try:
                msg = json.loads(data).get("error", data.decode())
            except Exception:
                msg = data.decode(errors="replace")
            raise PIVServerError(status, msg)
        with np.load(io.BytesIO(data)) as z:
            return {k: z[k] for k in z.files}

    def _post_pairs(self, body: bytes):
        return self._decode_response(*self._request("/piv", body))

    # ---- analysis ----------------------------------------------------------
    def analyze(self, frame_a: np.ndarray, frame_b: np.ndarray
                ) -> Optional[Tuple[np.ndarray, ...]]:
        """One pair -> ``(x, y, u, v, invalid)``; None when the server
        skipped it (>50 % of the vectors invalid)."""
        res = self._post_pairs(_npz_bytes(a=frame_a, b=frame_b))
        if res is None:
            return None
        return res["x"], res["y"], res["u"], res["v"], res["invalid"]

    def analyze_burst(self, frames_a: np.ndarray, frames_b: np.ndarray
                      ) -> Optional[dict]:
        """A stacked ``[B,H,W]`` burst -> dict with ``x, y`` (2-D) and
        ``u, v, invalid, skipped_pairs`` carrying the leading pair axis
        (skipped pairs are NaN planes).  None when EVERY pair skipped."""
        if np.ndim(frames_a) != 3:
            raise ValueError("analyze_burst expects stacked [B,H,W] arrays")
        return self._post_pairs(_npz_bytes(a=frames_a, b=frames_b))

    def analyze_files(self, path_a: str, path_b: str
                      ) -> Optional[Tuple[np.ndarray, ...]]:
        """A pair of SERVER-readable files (shared filesystem)."""
        body = json.dumps({"a": path_a, "b": path_b}).encode()
        res = self._decode_response(
            *self._request("/piv_files", body, "application/json"))
        if res is None:
            return None
        return res["x"], res["y"], res["u"], res["v"], res["invalid"]

    # ---- operations --------------------------------------------------------
    def health(self) -> dict:
        status, data = self._request("/healthz")
        if status != 200:
            raise PIVServerError(status, data.decode(errors="replace"))
        return json.loads(data)

    def config(self) -> dict:
        status, data = self._request("/config")
        if status != 200:
            raise PIVServerError(status, data.decode(errors="replace"))
        return json.loads(data)

    def metrics(self) -> str:
        status, data = self._request("/metrics")
        if status != 200:
            raise PIVServerError(status, data.decode(errors="replace"))
        return data.decode()
