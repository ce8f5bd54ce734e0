"""The state the port shares with the JAX engine.

PIV has no learned weights: what has to agree is the configuration and the
static operators built from it (per-pass grids, coordinates, window
origins, spline upsample matrices), which ``MultipassPIV`` derives from the
config and, for the region-of-interest mask, from ``frame_mask``.
"""
from __future__ import annotations

import dataclasses
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


def _jax_engine(obj):
    """The JAX ``MultipassPIV`` a JAX model holds (``engine`` or a jitted
    ``_engine``), or None."""
    eng = getattr(obj, "engine", None) or getattr(obj, "_engine", None)
    return getattr(eng, "__wrapped__", eng)


def from_jax_model(obj, device="cpu"):
    """The port's counterpart of a JAX ``EnsemblePIV``, ``MultiDtPIV``,
    ``FolkiPIV`` or ``PTV``, built from that instance's attributes: the
    engine's config (``from_jax_config``), and the model's own settings
    (separations and merge limits; frame shape, window, radius, iterations,
    levels and the two FOLKI thresholds; particle capacity, suppression
    distance, threshold, filter width, search radius and ``frame_mask``).
    Like ``from_jax_engine_state`` it reads attributes only; the embedded
    engine's buffers then equal ``from_jax_engine_state`` of the JAX one."""
    from . import models

    kind = type(obj).__name__
    eng = _jax_engine(obj)
    config = None if eng is None else from_jax_config(dataclasses.asdict(eng.config))
    if kind == "EnsemblePIV":
        return models.EnsemblePIV(config, device=device)
    if kind == "MultiDtPIV":
        return models.MultiDtPIV(config, obj.separations, obj.max_disp_frac,
                                 obj.consistency_px, device=device)
    if kind == "FolkiPIV":
        return models.FolkiPIV(
            obj.frame_shape, obj.wind_size, obj.wind_size - obj._step,
            radius=obj.radius, iters=obj.iters, levels=obj.levels,
            residual_threshold=obj.residual_threshold,
            min_contrast=obj.min_contrast, piv_config=config, device=device)
    if kind == "PTV":
        return models.PTV(
            obj.frame_shape, piv_config=config, max_particles=obj.max_particles,
            min_distance=obj.min_distance, n_sigma=obj.n_sigma,
            smooth_sigma=obj.smooth_sigma, search_radius=obj.search_radius,
            frame_mask=obj.frame_mask, device=device)
    raise TypeError(f"from_jax_model: no counterpart of {kind}")
