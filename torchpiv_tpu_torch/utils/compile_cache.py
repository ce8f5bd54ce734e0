"""The port's build cache: where the package's native code is compiled
(counterpart of ``torchpiv_tpu/utils/compile_cache.py``).

What a cold process pays for in the JAX package is XLA compiling the
engine graph, which its persistent compilation cache removes.  What a cold
process pays for in the port is ``nvcc`` building each CUDA source of
``kernels/csrc/`` and ``g++`` building ``native/fastio.cpp``: both write
their shared libraries into one directory, resolved here, under names that
carry a hash of what went into them, so a later process loads them from
disk instead of building them again.

``TORCHPIV_CACHE_DIR``, the JAX package's variable for the same role,
names that directory; the default is ``torchpiv_tpu_torch/_build/`` beside
the package's sources.  It is read once per process: the first caller
wins, as in the JAX package, so the kernels and the decoder of one process
always share a directory.

The JAX module's other knobs have no counterpart: ``JAX_COMPILATION_CACHE_DIR``
and the ``jax.config`` settings are XLA's, and ``TORCHPIV_NO_COMPILE_CACHE``
would have nothing to turn off, since a CUDA kernel cannot run unbuilt.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional

_lock = threading.Lock()
_enabled_dir: Optional[str] = None


def default_cache_dir() -> str:
    """``torchpiv_tpu_torch/_build/`` of this checkout or installation."""
    return str(Path(__file__).resolve().parents[1] / "_build")


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """The build directory of this process (idempotent): ``cache_dir``,
    else ``TORCHPIV_CACHE_DIR``, else :func:`default_cache_dir`, fixed by
    the first call.  The directory is made by the first build that writes
    into it."""
    global _enabled_dir
    with _lock:
        if _enabled_dir is None:
            _enabled_dir = str(Path(
                cache_dir or os.environ.get("TORCHPIV_CACHE_DIR")
                or default_cache_dir()).resolve())
        return _enabled_dir


def build_dir() -> Path:
    """The build directory of this process as a ``Path``."""
    return Path(enable_compile_cache())
