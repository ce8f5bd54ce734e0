"""Ensemble statistics (the ported part of ``torchpiv_tpu.stats``)."""

from .ensemble import EnsembleAccumulator, compute_statistics

__all__ = ["EnsembleAccumulator", "compute_statistics"]
