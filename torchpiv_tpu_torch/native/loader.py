"""ctypes binding and build at first use of the native bulk decoder
``fastio.cpp``: the port's copy of ``torchpiv_tpu/native/loader.py``.

``fastio.cpp`` is compiled with ``g++`` at first use into the port's
build directory, the one the CUDA kernels use (``utils.compile_cache``:
``torchpiv_tpu_torch/_build/`` or ``TORCHPIV_CACHE_DIR``), under a name
that carries a hash of the source, the flags, the compiler's version, the
machine and the C library, never beside the source.  It reads and decodes whole batches of 8-bit palette BMP,
uncompressed grayscale TIFF (8 or 16 bits, either byte order) and PGM P5
(8 or 16 bits) on C++ threads, with the interpreter lock released, into a
caller's buffer if one is given.  Where no compiler exists the library is
unavailable and the callers keep the Python decoders, as the JAX
package's loader does; that is logged once.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..utils.compile_cache import build_dir

log = logging.getLogger("torchpiv_tpu_torch")

SOURCE = Path(__file__).resolve().parent / "fastio.cpp"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _target() -> Path:
    """The library's path: named by the source, the flags and the toolchain
    it is built with (raises when there is no ``g++``)."""
    version = subprocess.run(["g++", "-dumpfullversion", "-dumpversion"],
                             capture_output=True, text=True, check=True).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (" ".join(FLAGS), version.strip(), platform.machine(),
                 " ".join(platform.libc_ver())):
        h.update(part.encode())
    return build_dir() / f"libfastio-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    so = _target()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
            lib.fastio_probe_bmp8.restype = ctypes.c_int
            lib.fastio_probe_bmp8.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            lib.fastio_read_batch.restype = None
            lib.fastio_read_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32)]
            lib.fastio_write_table.restype = ctypes.c_int
            lib.fastio_write_table.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_char_p]
            _lib = lib
        except Exception as e:  # no g++, a build error, a load error
            log.info("native fastio unavailable (%s); using Python decode", e)
            _failed = True
        return _lib


def library_path() -> Optional[Path]:
    """Where the loaded library lives, or None when it is unavailable."""
    return Path(_lib._name) if _load() is not None else None


def available() -> bool:
    return _load() is not None


def probe_gray(path: str) -> Optional[Tuple[int, int]]:
    """``(H, W)`` if the native decoder can handle this file, else None."""
    lib = _load()
    if lib is None:
        return None
    dims = (ctypes.c_int64 * 2)()
    if lib.fastio_probe_bmp8(path.encode(), dims) != 0:
        return None
    return int(dims[0]), int(dims[1])


def read_batch_gray(paths: List[str], shape: Tuple[int, int], threads: int = 8,
                    out: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Read and decode a batch of gray frames of one shape on ``threads``
    C++ threads -> ``(frames [n, H, W] uint8, status [n] int32)``; status
    != 0 marks a file that failed (missing, corrupt, truncated or of
    another shape), whose frame is undefined.  16-bit samples keep
    their high byte.  ``out`` (a C-contiguous, writable uint8 ``[n, H,
    W]`` array, pinned host memory for instance) receives the frames and is
    returned; else they go to a new array."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastio not available")
    H, W = shape
    n = len(paths)
    if out is None:
        out = np.empty((n, H, W), dtype=np.uint8)
    elif (out.dtype != np.uint8 or out.shape != (n, H, W)
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous uint8 array of shape "
                         f"{(n, H, W)}, not {out.dtype} {out.shape}")
    status = np.empty(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.fastio_read_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
        max(1, threads), status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, status


def write_table(path: str, header: str, arr: np.ndarray, sep: str = ", ") -> None:
    """Write a ``[N, C]`` float64 array as a headed "%.6f" table on the C
    side, byte-identical to ``np.savetxt(fmt="%.6f", delimiter=sep,
    header=header, comments="")``; raises on failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastio not available")
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    if arr.ndim != 2:
        raise ValueError(f"expected [N, C] table, got shape {arr.shape}")
    rc = lib.fastio_write_table(
        path.encode(), header.encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        arr.shape[0], arr.shape[1], sep.encode())
    if rc != 0:
        raise OSError(f"fastio_write_table({path!r}) failed with rc={rc}")
