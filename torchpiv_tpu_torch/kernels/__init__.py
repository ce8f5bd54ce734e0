"""Hand-written CUDA kernels of the port, each beside its plain version."""
from . import peakfit as _peakfit  # the module keeps its name: no re-export
from .corrfit import correlate_peakfit
from .deform import def_windows
from .fused_pass import fused_piv_pass
from .shift import (shift_windows, shift_windows_bf16, shift_windows_bicubic,
                    shift_windows_lanephases, shift_windows_mxu,
                    shift_windows_phases)

KERNELS = (shift_windows, shift_windows_bicubic, def_windows, _peakfit.peakfit,
           correlate_peakfit, fused_piv_pass, shift_windows_bf16,
           shift_windows_lanephases, shift_windows_mxu, shift_windows_phases)

__all__ = ["KERNELS", "correlate_peakfit", "def_windows", "fused_piv_pass",
           "shift_windows", "shift_windows_bf16", "shift_windows_bicubic",
           "shift_windows_lanephases", "shift_windows_mxu",
           "shift_windows_phases"]
