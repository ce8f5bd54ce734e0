"""Device meshes (counterpart of ``torchpiv_tpu/parallel/mesh.py``).

The only meaningful parallel axes in PIV are the *pair batch*
(embarrassingly parallel) and the *window grid* of one pair (window
extraction, correlation and peak fit are per window; only the spline
predictor upsample between passes couples windows).  ``ShardedPIV``
(``parallel.sharded``) splits over the two axes of a ``Mesh``.

``Mesh`` stands in for ``jax.sharding.Mesh`` as ``ShardedPIV`` uses it: an
ndarray of ``torch.device`` with one dimension a named axis, and ``.shape``
the axis name -> size dict.

A device may appear more than once when the caller passes ``devices``
(``make_mesh(axes, [torch.device("cpu")] * 8)``, or ``[cuda:0] * 4``).  The
shards on one device then run one after another.  That is a necessity of the
port, not a feature: the CPU tests need a mesh of several "devices" (where
the JAX tests force eight virtual CPU devices), and a machine with one card
can only run a split over that card named more than once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """``devices``: an ndarray of ``torch.device``, one dimension per name
    of ``axis_names``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_list(self) -> List[torch.device]:
        """The devices in row-major order (repeats included)."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.device_list]})"


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass devices "
                           "(for example [torch.device('cpu')] * 8) to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device, so that one card has one name."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh over ``devices`` (default: every CUDA device).

    ``axes`` maps axis name -> size; the sizes' product must not exceed the
    device count (the first that many devices are used); default is a 1-D
    ``{"pairs": n_devices}`` mesh.  Raises ``ValueError`` when the axes need
    more devices than given."""
    devices = [_indexed(torch.device(d)) for d in (devices if devices is not None
                                                   else _cuda_devices())]
    n = len(devices)
    if axes is None:
        axes = {"pairs": n}
    sizes = [int(s) for s in axes.values()]
    need = int(np.prod(sizes))
    if need > n:
        raise ValueError(f"mesh axes {axes} need {need} devices, have {n}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = d
    return Mesh(arr.reshape(sizes), tuple(axes.keys()))


def default_piv_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Two-axis mesh heuristic over the CUDA devices: mostly pairs-parallel,
    x2 window-parallel when the device count is even and > 2."""
    all_devices = _cuda_devices()
    devices = all_devices[: n_devices or len(all_devices)]
    n = len(devices)
    if n > 2 and n % 2 == 0:
        return make_mesh({"pairs": n // 2, "windows": 2}, devices)
    return make_mesh({"pairs": n}, devices)
