"""Hand-written CUDA kernels of the port, each beside its plain version."""
from .shift import shift_windows

KERNELS = (shift_windows,)

__all__ = ["KERNELS", "shift_windows"]
