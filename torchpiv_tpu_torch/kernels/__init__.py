"""Hand-written CUDA kernels of the port, each beside its plain version."""
from . import peakfit as _peakfit  # the module keeps its name: no re-export
from .deform import def_windows
from .shift import shift_windows, shift_windows_bicubic

KERNELS = (shift_windows, shift_windows_bicubic, def_windows, _peakfit.peakfit)

__all__ = ["KERNELS", "def_windows", "shift_windows", "shift_windows_bicubic"]
