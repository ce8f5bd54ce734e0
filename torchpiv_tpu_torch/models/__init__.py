"""The models (counterpart of ``torchpiv_tpu/models``): the multipass
engine, ensemble (correlation-averaged) PIV, multi-frame PIV, dense
Lucas-Kanade PIV and PIV-guided particle tracking."""

from ..config import PIVConfig
from .ensemble_corr import EnsemblePIV
from .folki import FolkiPIV, folki_flow
from .multidt import MultiDtPIV, MultiDtResult, merge_multi_dt
from .multipass import MultipassPIV
from .ptv import (PTV, PTVResult, Trajectory, bin_to_grid,
                  link_trajectories, match_particles)

__all__ = ["MultipassPIV", "PIVConfig", "EnsemblePIV", "FolkiPIV",
           "folki_flow", "MultiDtPIV",
           "MultiDtResult", "merge_multi_dt", "PTV", "PTVResult",
           "Trajectory", "bin_to_grid", "link_trajectories",
           "match_particles"]
