"""The state the port shares with the JAX engine.

PIV has no learned weights: what has to agree is the configuration and the
static operators built from it (per-pass grids, coordinates, window
origins, spline upsample matrices), which ``MultipassPIV`` derives from the
config and, for the region-of-interest mask, from ``frame_mask``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import PIVConfig


def from_jax_config(d: dict) -> PIVConfig:
    """The port's ``PIVConfig`` from ``dataclasses.asdict`` of a JAX
    ``PIVConfig``; every knob carries across, and what the port does not
    run (``config.py``) raises ``ValueError``."""
    return PIVConfig.from_dict(d)


def from_jax_engine_state(engine) -> Dict[str, torch.Tensor]:
    """The static numpy state of a JAX ``MultipassPIV`` as the port's
    buffers, keyed by the port engine's buffer names: ``frame_mask`` and
    ``window_masked_{p}`` (bool; absent without a mask), ``origins_{p}``
    and the spline upsamplers ``Ay_{p}``/``Ax_{p}``.  It reads attributes
    only, so it needs neither JAX nor the JAX package: a test can hold an
    engine of the port to ``from_jax_engine_state(jax_engine)`` key by key,
    or load it with ``load_state_dict(..., strict=False)``."""
    state = {}
    if engine.frame_mask is not None:
        state["frame_mask"] = torch.from_numpy(np.asarray(engine.frame_mask, bool))
    for p, masked in enumerate(engine.window_masked):
        if masked is not None:
            state[f"window_masked_{p}"] = torch.from_numpy(np.asarray(masked, bool))
    for p, (r0, c0) in enumerate(engine.origins):
        state[f"origins_{p}"] = torch.from_numpy(np.stack([r0, c0]))
    for p, (Ay, Ax) in enumerate(engine.upsamplers, start=1):
        state[f"Ay_{p}"] = torch.from_numpy(np.array(Ay, dtype=np.float32))
        state[f"Ax_{p}"] = torch.from_numpy(np.array(Ax, dtype=np.float32))
    return state
