"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles at first use into a shared library with a
plain C interface, in the build directory of ``utils.compile_cache``
(``torchpiv_tpu_torch/_build/``, or ``TORCHPIV_CACHE_DIR``).  The
library's file name carries a hash of its source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header builds
anew and an unchanged one loads from disk.  Only sources of this package are built;
nothing is fetched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

from ..utils.compile_cache import build_dir

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def __getattr__(name: str):
    # ``BUILD_DIR``: the directory resolved at the first build, not at import
    if name == "BUILD_DIR":
        return build_dir()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the package's kernels")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any header
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns ``(process, tmp, target)`` or
    None when the library is already built."""
    so = _target(name)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish(name: str, started) -> str:
    """Wait for a started ``nvcc``; returns what it printed."""
    proc, tmp, so = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, so)
    return log


def sources() -> list:
    """Names of every kernel source of the package."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build() -> None:
    """Build every source, one ``nvcc`` per source, all started together."""
    with _lock:
        started = [(n, _start(n)) for n in sources()]
        for n, s in started:
            if s is not None:
                _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            s = _start(name)
            if s is not None:
                _finish(name, s)
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: Sequence):
    """The C function ``symbol`` of ``csrc/<name>.cu`` (it returns the
    launch's ``cudaGetLastError()``), with its argument types set."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


DESCRIBE_KEYS = ("registers", "local_bytes", "shared_bytes", "threads", "windows")


def describe(name: str, *args: int) -> Dict[str, int]:
    """What the compiler made of a kernel of ``csrc/<name>.cu``: its C
    function ``<name>_describe(*args, out)`` fills registers a thread, bytes
    of local memory a thread (spills and stack), bytes of shared memory a
    block, threads a block and windows a block of the instance that
    ``args`` select."""
    fn = function(name, f"{name}_describe",
                  [ctypes.c_int] * len(args) + [ctypes.c_void_p])
    out = (ctypes.c_int * len(DESCRIBE_KEYS))()
    check_launch(name, fn(*args, out))
    return dict(zip(DESCRIBE_KEYS, out))


def check_launch(name: str, rc: int) -> None:
    """Raise if the launch of ``csrc/<name>.cu`` returned a CUDA error."""
    if rc != 0:
        err = getattr(load(name), f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()} ({rc})")
