"""The state the port shares with the JAX engine.

PIV has no learned weights: what has to agree is the configuration and the
static operators built from it (per-pass grids, coordinates, window
origins, spline upsample matrices), which ``MultipassPIV`` derives from the
config.
"""
from __future__ import annotations

from .config import PIVConfig


def from_jax_config(d: dict) -> PIVConfig:
    """The port's ``PIVConfig`` from ``dataclasses.asdict`` of a JAX
    ``PIVConfig``; raises ``ValueError`` on knobs that are not ported."""
    return PIVConfig.from_dict(d)
