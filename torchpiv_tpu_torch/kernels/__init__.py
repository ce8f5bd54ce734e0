"""Hand-written CUDA kernels of the port, each beside its plain version."""
from . import peakfit as _peakfit  # the module keeps its name: no re-export
from .corrfit import correlate_peakfit
from .deform import def_windows
from .fused_pass import fused_piv_pass
from .shift import shift_windows, shift_windows_bicubic

KERNELS = (shift_windows, shift_windows_bicubic, def_windows, _peakfit.peakfit,
           correlate_peakfit, fused_piv_pass)

__all__ = ["KERNELS", "correlate_peakfit", "def_windows", "fused_piv_pass",
           "shift_windows", "shift_windows_bicubic"]
