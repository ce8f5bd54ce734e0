"""Vector-field outlier validation beyond the peak ratio (counterpart of
``torchpiv_tpu/ops/validation.py``): the median test and the normalized
median (universal outlier) test of Westerweel & Scarano (Exp. Fluids 39,
2005) over the 3x3 neighbourhood, the acceptance test of secondary-peak
substitution, velocity limits and the global mean +- k*sigma test.

Every function takes fields ``[..., R, C]``: leading axes are pairs, and all
statistics are per pair (the JAX functions see one ``[R, C]`` field under
``vmap``).  The neighbour stacks put the neighbour axis first,
``[8 | 16, ..., R, C]``.

``_nanmedian8`` is the JAX function's sort-and-take arithmetic, not
``torch.nanmedian``, which returns the lower of the two middle values where
this one averages them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _nan_pad(field: torch.Tensor, p: int) -> torch.Tensor:
    return torch.nn.functional.pad(field, (p, p, p, p), value=float("nan"))


def _neighbors(field: torch.Tensor) -> torch.Tensor:
    """Stack of the 8 neighbours of every grid point, edge-padded with NaN
    so border points are judged only against their real neighbours.
    Returns ``[8, ..., R, C]``."""
    f = _nan_pad(field, 1)
    R, C = field.shape[-2:]
    return torch.stack([f[..., 1 + di:1 + di + R, 1 + dj:1 + dj + C]
                        for di in (-1, 0, 1) for dj in (-1, 0, 1)
                        if (di, dj) != (0, 0)])


def _neighbors_ring2(field: torch.Tensor) -> torch.Tensor:
    """Stack of the 16 second-ring neighbours (Chebyshev distance 2) of
    every grid point, edge-padded with NaN.  Returns ``[16, ..., R, C]``."""
    f = _nan_pad(field, 2)
    R, C = field.shape[-2:]
    return torch.stack([f[..., 2 + di:2 + di + R, 2 + dj:2 + dj + C]
                        for di in range(-2, 3) for dj in range(-2, 3)
                        if max(abs(di), abs(dj)) == 2])


def _nanmedian8(stack: torch.Tensor) -> torch.Tensor:
    """NaN-aware median over the leading axis of a neighbour stack: sort
    with NaN pushed to the end (+inf) and average the middle pair of the
    valid count; 0 where no neighbour is valid."""
    nan = torch.isnan(stack)
    n_valid = (~nan).sum(dim=0)
    s = torch.sort(torch.where(nan, torch.inf, stack), dim=0).values
    hi = torch.clamp(torch.div(n_valid, 2, rounding_mode="floor"), min=0)
    lo = torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"), min=0)
    med = 0.5 * (torch.gather(s, 0, lo[None])[0] + torch.gather(s, 0, hi[None])[0])
    return torch.where(n_valid > 0, med, 0.0)


def median_test(u: torch.Tensor, v: torch.Tensor,
                threshold: float = 2.0) -> torch.Tensor:
    """Classic median test: flag vectors deviating from the neighbourhood
    median by more than ``threshold`` in either component."""
    bad = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    for f in (u, v):
        med = _nanmedian8(_neighbors(f))
        bad = bad | ((f - med).abs() > threshold)
    return bad


def normalized_median_test(u: torch.Tensor, v: torch.Tensor,
                           threshold: float = 2.0, eps: float = 0.1) -> torch.Tensor:
    """Universal outlier detection: ``r = |u - med| / (med(|u_j - med|) +
    eps)`` over the 3x3 neighbourhood; invalid when ``r > threshold`` in
    either component."""
    bad = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    for f in (u, v):
        nb = _neighbors(f)
        med = _nanmedian8(nb)
        resid = _nanmedian8((nb - med[None]).abs())
        bad = bad | ((f - med).abs() / (resid + eps) > threshold)
    return bad


def apply_median_filter(u: torch.Tensor, v: torch.Tensor,
                        invalid: Optional[torch.Tensor], mode: str,
                        threshold: float = 2.0) -> torch.Tensor:
    """Combine the configured median-family test with an existing mask."""
    if mode == "median":
        extra = median_test(u, v, threshold)
    elif mode == "normmedian":
        extra = normalized_median_test(u, v, threshold)
    else:
        raise ValueError(f"unknown median_filter {mode!r}")
    return extra if invalid is None else (invalid | extra)


def second_peak_acceptance(u: torch.Tensor, v: torch.Tensor,
                           invalid: torch.Tensor, cand_u: torch.Tensor,
                           cand_v: torch.Tensor, threshold: float = 2.0,
                           eps: float = 0.1, min_neighbors: int = 5) -> torch.Tensor:
    """Acceptance mask for secondary-peak substitution: a candidate at an
    invalid site is accepted when it passes the normalized-median criterion
    against the surrounding VALID vectors, in both components, on both the
    3x3 ring and the second ring, each with at least ``min_neighbors`` valid
    members.  Always a subset of ``invalid``."""
    ok = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    for f, c in ((u, cand_u), (v, cand_v)):
        fv = torch.where(invalid, torch.nan, f)
        for nb in (_neighbors(fv), _neighbors_ring2(fv)):
            n_valid = (~torch.isnan(nb)).sum(dim=0)
            med = _nanmedian8(nb)
            resid = _nanmedian8((nb - med[None]).abs())
            r = (c - med).abs() / (resid + eps)
            ok = ok & (r <= threshold) & (n_valid >= min_neighbors)
    return ok & invalid


def velocity_limits_test(u: torch.Tensor, v: torch.Tensor,
                         u_limits: Optional[Tuple[float, float]] = None,
                         v_limits: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Flag vectors whose components fall outside ``[min, max]`` bounds, in
    pixel-displacement units."""
    bad = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    if u_limits is not None:
        bad = bad | (u < u_limits[0]) | (u > u_limits[1])
    if v_limits is not None:
        bad = bad | (v < v_limits[0]) | (v > v_limits[1])
    return bad


def global_std_test(u: torch.Tensor, v: torch.Tensor, k: float = 5.0,
                    invalid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean +- k*sigma filter per component, with each pair's statistics
    taken over its currently valid vectors only."""
    w = torch.ones_like(u) if invalid is None else (~invalid).to(u.dtype)
    n = torch.clamp(w.sum(dim=(-2, -1), keepdim=True), min=1.0)

    def outside(f):
        mean = (w * f).sum(dim=(-2, -1), keepdim=True) / n
        var = (w * (f - mean) ** 2).sum(dim=(-2, -1), keepdim=True) / n
        sd = torch.sqrt(var)
        return (f < mean - k * sd) | (f > mean + k * sd)

    bad = outside(u) | outside(v)
    return bad if invalid is None else (invalid | bad)
