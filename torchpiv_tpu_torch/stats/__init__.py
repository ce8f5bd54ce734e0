"""Ensemble statistics (L4): means, Reynolds stresses, vorticity/shear;
measurement-quality diagnostics (peak locking, SNR maps, uncertainty);
pressure reconstruction (Poisson, time-resolved and RANS-mean);
robust field smoothing (smoothn); snapshot POD and DMD; spatial energy
spectra; derived maps (divergence, swirling strength, Okubo-Weiss);
temporal analysis for time-resolved runs (probe PSDs, integral time
scale, convergence); turbulence scales (TKE, dissipation, Kolmogorov /
Taylor / integral scales).  Counterpart of ``torchpiv_tpu/stats``: the
quality maps run on the device, the rest are copies of the host modules."""

from .derived import (derived_fields, divergence, find_vortex_cores,
                      gradient_uncertainty,
                      gamma_functions,
                      okubo_weiss, swirling_strength,
                      track_vortex_cores, velocity_gradients, vorticity)
from .dmd import DMDResult, compute_dmd
from .ensemble import EnsembleAccumulator, compute_statistics
from .pod import PODResult, compute_pod
from .spod import SPODResult, compute_spod
from .pressure import (mean_pressure_rans, pressure_from_stack,
                       pressure_poisson, solve_poisson_neumann)
from .quality import (fractional_histogram, peak_locking_degree,
                      peak_width_map, snr_map, uncertainty_map)
from .smoothing import smooth_field, smooth_vector_field
from .spectra import energy_spectrum, spatial_spectrum
from .turbulence import (dissipation_direct, integral_length_scale,
                         kolmogorov_scales, taylor_microscale,
                         taylor_reynolds, turbulence_report,
                         turbulent_kinetic_energy)
from .temporal import (autocorrelation, convergence_report,
                       integral_time_scale, load_pair_stack,
                       phase_average, phase_from_probe, probe_series,
                       running_mean, welch_psd)

__all__ = [
    "EnsembleAccumulator",
    "PODResult",
    "autocorrelation",
    "compute_pod",
    "SPODResult",
    "compute_spod",
    "DMDResult",
    "compute_dmd",
    "compute_statistics",
    "convergence_report",
    "integral_time_scale",
    "load_pair_stack",
    "phase_average",
    "phase_from_probe",
    "probe_series",
    "running_mean",
    "welch_psd",
    "dissipation_direct",
    "integral_length_scale",
    "kolmogorov_scales",
    "taylor_microscale",
    "taylor_reynolds",
    "turbulence_report",
    "turbulent_kinetic_energy",
    "derived_fields",
    "divergence",
    "gamma_functions",
    "find_vortex_cores",
    "gradient_uncertainty",
    "track_vortex_cores",
    "energy_spectrum",
    "fractional_histogram",
    "peak_locking_degree",
    "peak_width_map",
    "mean_pressure_rans",
    "pressure_from_stack",
    "pressure_poisson",
    "solve_poisson_neumann",
    "okubo_weiss",
    "smooth_field",
    "smooth_vector_field",
    "snr_map",
    "spatial_spectrum",
    "swirling_strength",
    "uncertainty_map",
    "velocity_gradients",
    "vorticity",
]
