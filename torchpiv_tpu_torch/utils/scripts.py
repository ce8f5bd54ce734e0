"""What the scripts beside the package share (``examples/*_cuda.py``,
``tools/*_cuda.py``): their device arguments, the figures' optional
dependency and the examples' vortex."""
from __future__ import annotations

import argparse

import numpy as np


def add_device_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--device`` (default: ``TPIV_DEVICE``, else the card; resolved by
    ``utils.device.script_device``) and the engine's ``--use-pallas``."""
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:<i> or cpu; TPIV_DEVICE also names it")
    ap.add_argument("--use-pallas", default="auto", choices=("auto", "on", "off"),
                    help="the engine's use_pallas: the kernels' semantics (auto, on) "
                         "or the JAX engine's XLA paths as torch ops (off)")
    return ap


def example_args(argv, doc: str) -> argparse.Namespace:
    """An example's arguments: the output directory (default
    ``./demo_out``, as the JAX examples) and the device arguments."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="./demo_out")
    return add_device_args(ap).parse_args(argv)


def have_matplotlib() -> bool:
    """Whether figures can be drawn; says so on standard output when not."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is not installed: no figure drawn")
        return False
    return True


def vortex_flow(cx, cy, strength=4.0, radius=150.0):
    """The JAX examples' vortex about ``(cx, cy)`` as a displacement
    function ``(xs, ys) -> (dx, dy)``: tangential, ``strength * (r / radius)
    * exp(1 - r / radius)`` px, largest (``strength``) at ``radius``."""
    def disp(xs, ys):
        dx = xs - cx
        dy = ys - cy
        r = np.hypot(dx, dy) + 1e-6
        mag = strength * (r / radius) * np.exp(1 - r / radius)
        return -mag * dy / r, mag * dx / r

    return disp
