"""PTV (particle tracking velocimetry): scattered per-particle vectors
(counterpart of ``torchpiv_tpu/models/ptv.py``; ``PTVResult``,
``match_particles``, ``Trajectory``, ``greedy_link_steps``,
``link_trajectories`` and ``bin_to_grid`` are copied).

Hybrid PIV-guided PTV is the standard super-resolution scheme (Keane,
Adrian & Zhang, Meas. Sci. Technol. 6 (1995)): a coarse correlation field
predicts where each frame-A particle lands in frame B, and the tracker only
has to resolve the residual, which keeps tracking reliable at seeding
densities where nearest-neighbour matching alone breaks down.

Particle DETECTION is the per-pixel work and runs on the device, both
frames in one batched ``detect_particles`` call (``ops/particles.py``), and
so does the guided predictor's engine; MATCHING works on a few thousand
scattered points on the host (scipy's cKDTree), like the rest of the
post-processing tail.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.geometry import get_coordinates
from ..ops.particles import detect_particles
from ..utils.device import resolve_device
from .multipass import MultipassPIV


@dataclass
class PTVResult:
    """Scattered tracks for one frame pair (image coordinates, px).

    ``x``/``y``: frame-A particle positions; ``u``/``v``: displacement to
    the matched frame-B particle (u = +x/cols, v = +y/rows);
    ``residual``: distance between predictor and match (px) — large
    values flag suspect tracks; ``n_a``/``n_b``: detection counts.
    """

    x: np.ndarray
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    residual: np.ndarray
    n_a: int
    n_b: int


def match_particles(
    xa: np.ndarray,
    ya: np.ndarray,
    xb: np.ndarray,
    yb: np.ndarray,
    pred_u: Optional[np.ndarray] = None,
    pred_v: Optional[np.ndarray] = None,
    radius: float = 5.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy unique nearest-neighbour matching under a search radius.

    Each frame-A particle is displaced by its predictor (zero when
    absent) and matched to the nearest unclaimed frame-B particle within
    ``radius``; candidates are claimed in ascending-distance order, so a
    closer pair always wins a contested particle.  Returns ``(ia, ib,
    dist)`` index arrays of the matched pairs.
    """
    from scipy.spatial import cKDTree

    xa = np.asarray(xa, dtype=np.float64)
    ya = np.asarray(ya, dtype=np.float64)
    xb = np.asarray(xb, dtype=np.float64)
    yb = np.asarray(yb, dtype=np.float64)
    if xa.size == 0 or xb.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0)
    px = xa + (0.0 if pred_u is None else np.asarray(pred_u))
    py = ya + (0.0 if pred_v is None else np.asarray(pred_v))
    tree = cKDTree(np.column_stack([xb, yb]))
    # k nearest candidates per A-particle, then a global greedy pass
    k = min(4, xb.size)
    dist, idx = tree.query(np.column_stack([px, py]), k=k,
                           distance_upper_bound=radius)
    dist = np.atleast_2d(dist.T).T
    idx = np.atleast_2d(idx.T).T
    cand = [(dist[i, c], i, idx[i, c])
            for i in range(xa.size) for c in range(k)
            if np.isfinite(dist[i, c])]
    cand.sort()
    used_a = np.zeros(xa.size, dtype=bool)
    used_b = np.zeros(xb.size, dtype=bool)
    ia, ib, dd = [], [], []
    for d, i, j in cand:
        if used_a[i] or used_b[j]:
            continue
        used_a[i] = used_b[j] = True
        ia.append(i)
        ib.append(j)
        dd.append(d)
    return (np.asarray(ia, dtype=np.int64), np.asarray(ib, dtype=np.int64),
            np.asarray(dd))


@dataclass
class Trajectory:
    """One particle followed across frames (image coordinates, px).

    ``frames[k]`` is the frame index where the particle sits at
    ``(x[k], y[k])``; positions come from the frame-A detection of each
    linked pair plus the final match endpoint, so a trajectory spanning
    P consecutive pairs has P+1 samples.
    """

    frames: np.ndarray
    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return int(self.frames.size)

    def kinematics(self, dt: float = 1.0):
        """Central-difference velocity and acceleration along the track
        (px per time unit; ends use one-sided differences).  Returns
        ``(u, v, ax, ay)`` arrays matching the sample count."""
        if self.frames.size < 2:
            raise ValueError("need >= 2 samples for kinematics")
        u = np.gradient(self.x, dt, edge_order=1)
        v = np.gradient(self.y, dt, edge_order=1)
        if self.frames.size < 3:
            return u, v, np.zeros_like(u), np.zeros_like(v)
        return (u, v, np.gradient(u, dt, edge_order=1),
                np.gradient(v, dt, edge_order=1))


def greedy_link_steps(steps, radius: float, accept=None) -> list:
    """Generic frame-to-frame linker shared by particle trajectories and
    vortex-core tracking (stats/derived.py).

    ``steps``: iterable of ``(index, pos_in [N,2], pos_out [N,2],
    payloads)`` — this step's ``pos_in`` is matched (greedy unique
    nearest-neighbour within ``radius``) against the previous step's
    linked items' ``pos_out``; for single-position items pass the same
    array twice.  An ``index`` gap closes every open track (nothing may
    link across missing data).  ``accept(prev_payload, new_payload)`` can
    veto a link (e.g. a vortex must keep its rotation sense).  Returns
    chains as lists of ``(step_index, item_index, payload)``.
    """
    open_tracks: list = []
    ends = np.zeros((0, 2))
    done: list = []
    prev_idx = None
    for idx, pos_in, pos_out, payloads in steps:
        if prev_idx is not None and idx != prev_idx + 1:
            done.extend(open_tracks)
            open_tracks = []
            ends = np.zeros((0, 2))
        prev_idx = idx
        pos_in = np.asarray(pos_in, dtype=np.float64).reshape(-1, 2)
        pos_out = np.asarray(pos_out, dtype=np.float64).reshape(-1, 2)
        ia, ib, _ = match_particles(ends[:, 0], ends[:, 1],
                                    pos_in[:, 0], pos_in[:, 1],
                                    radius=radius)
        linked = dict(zip(ia.tolist(), ib.tolist()))
        n_items = pos_in.shape[0]
        taken = np.zeros(n_items, dtype=bool)
        nxt, nends = [], []
        for t, trk in enumerate(open_tracks):
            j = linked.get(t)
            if j is None or (accept is not None
                             and not accept(trk[-1][2], payloads[j])):
                done.append(trk)
                continue
            taken[j] = True
            trk.append((idx, j, payloads[j]))
            nxt.append(trk)
            nends.append(pos_out[j])
        for j in np.nonzero(~taken)[0]:
            nxt.append([(idx, int(j), payloads[j])])
            nends.append(pos_out[j])
        open_tracks = nxt
        ends = np.asarray(nends) if nends else np.zeros((0, 2))
    done.extend(open_tracks)
    return done


def link_trajectories(
    results,
    radius: float = 2.0,
    min_length: int = 3,
    pair_indices=None,
) -> list:
    """Link per-pair PTV results over a SEQUENTIAL frame series into
    Lagrangian trajectories.

    ``results``: :class:`PTVResult` per consecutive pair — pair ``i``
    connects frames ``i -> i+1`` (``folder_mode="sequential"``).  A track
    in pair ``i`` ends at ``(x+u, y+v)``; a track in pair ``i+1`` starts
    at its detected frame-A position.  Endpoint and start refer to the
    SAME physical frame, so they are linked by proximity alone
    (``radius`` absorbs detection noise, not motion — keep it ~1-2 px).
    Matching is the same greedy unique nearest-neighbour used for pair
    tracking.  ``pair_indices`` (optional) gives each result's actual
    pair number when the series has gaps (e.g. an unreadable frame was
    skipped): a gap CLOSES every open track — linking across it would
    join positions a full frame of motion apart — and frame numbers in
    the output stay aligned with the real series.  Returns trajectories
    with at least ``min_length`` samples, longest first.
    """
    if pair_indices is None:
        pair_indices = list(range(len(results)))
    if len(pair_indices) != len(results):
        raise ValueError("pair_indices must match results")

    def steps():
        for p, res in zip(pair_indices, results):
            starts = np.column_stack([res.x, res.y])
            ends = np.column_stack([res.x + res.u, res.y + res.v])
            # payload: (start, end) positions of this pair's track
            yield p, starts, ends, list(zip(starts, ends))

    out = []
    for chain in greedy_link_steps(steps(), radius=radius):
        if len(chain) + 1 < min_length:
            continue
        # per linked pair keep the frame-A detection (re-measured, more
        # accurate than the previous pair's propagated endpoint); the
        # chain's final endpoint supplies the last sample
        frames = [p for p, _, _ in chain] + [chain[-1][0] + 1]
        xs = [pl[0][0] for _, _, pl in chain] + [chain[-1][2][1][0]]
        ys = [pl[0][1] for _, _, pl in chain] + [chain[-1][2][1][1]]
        out.append(Trajectory(frames=np.asarray(frames),
                              x=np.asarray(xs), y=np.asarray(ys)))
    out.sort(key=len, reverse=True)
    return out


def bin_to_grid(
    x: np.ndarray,
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    frame_shape: Tuple[int, int],
    wind_size: int = 32,
    overlap: int = 16,
    min_tracks: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bin scattered tracks onto the standard PIV coordinate grid.

    Gaussian-weighted averaging (sigma = half the grid step, the usual
    super-resolution binning) of all tracks within one window size of
    each node; nodes with fewer than ``min_tracks`` contributing tracks
    are NaN.  Returns ``(gx, gy, gu, gv, count)`` with the same
    ``get_coordinates`` grid the correlation engine uses, so PTV output
    drops into every downstream tool (stats, export, view).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    gx, gy = get_coordinates(frame_shape, wind_size, overlap)
    step = wind_size - overlap
    sigma = step / 2.0
    r, c = gx.shape
    gu = np.full((r, c), np.nan)
    gv = np.full((r, c), np.nan)
    count = np.zeros((r, c), dtype=np.int64)
    if x.size == 0:
        return gx, gy, gu, gv, count
    cut = float(wind_size)  # contribution radius
    # scatter by node offset: each track touches only nodes within
    # ceil(cut/step) grid steps, so loop over that small offset stencil
    # with N-length vector ops instead of looping over the 16k nodes.
    x0, y0 = float(gx[0, 0]), float(gy[0, 0])
    hx = np.rint((x - x0) / step).astype(np.int64)  # home node
    hy = np.rint((y - y0) / step).astype(np.int64)
    reach = int(np.ceil(cut / step))
    wsum = np.zeros((r, c))
    usum = np.zeros((r, c))
    vsum = np.zeros((r, c))
    for oy in range(-reach, reach + 1):
        for ox in range(-reach, reach + 1):
            iy = hy + oy
            ix = hx + ox
            ok = (iy >= 0) & (iy < r) & (ix >= 0) & (ix < c)
            if not ok.any():
                continue
            iyk, ixk = iy[ok], ix[ok]
            d2 = ((x[ok] - (x0 + ixk * step)) ** 2
                  + (y[ok] - (y0 + iyk * step)) ** 2)
            near = d2 < cut * cut
            if not near.any():
                continue
            iyk, ixk, d2 = iyk[near], ixk[near], d2[near]
            w = np.exp(-d2 / (2.0 * sigma * sigma))
            np.add.at(count, (iyk, ixk), 1)
            np.add.at(wsum, (iyk, ixk), w)
            np.add.at(usum, (iyk, ixk), w * u[ok][near])
            np.add.at(vsum, (iyk, ixk), w * v[ok][near])
    good = (count >= min_tracks) & (wsum > 0)
    gu[good] = usum[good] / wsum[good]
    gv[good] = vsum[good] / wsum[good]
    return gx, gy, gu, gv, count


class PTV(nn.Module):
    """PIV-guided particle tracker for a fixed frame shape.

    With ``piv_config`` (a ``PIVConfig``) the correlation engine provides
    the per-particle predictor and ``search_radius`` bounds only the
    residual; without it, plain nearest-neighbour tracking with a wider
    default radius.  ``frame_mask`` (True = excluded, an array or a mask
    image's path) drops the detections inside the region and masks the
    engine.

    >>> ptv = PTV((1024, 1024), piv_config=cfg)
    >>> res = ptv(frame_a, frame_b)     # res.x/y/u/v scattered, px
    """

    def __init__(
        self,
        frame_shape: Tuple[int, int],
        piv_config=None,
        max_particles: int = 4096,
        min_distance: int = 3,
        n_sigma: float = 4.0,
        smooth_sigma: float = 1.3,
        search_radius: Optional[float] = None,
        frame_mask=None,
        device="auto",
    ):
        # the pipeline imports the models: import its mask reader late
        from ..pipeline import resolve_frame_mask

        super().__init__()
        self.frame_shape = tuple(frame_shape)
        mask = resolve_frame_mask(frame_mask)
        if mask is not None and mask.shape != self.frame_shape:
            raise ValueError(f"frame_mask shape {mask.shape} "
                             f"!= frame shape {self.frame_shape}")
        self._device = resolve_device(device)
        self.register_buffer("frame_mask", None if mask is None
                             else torch.from_numpy(mask).to(self._device))
        self.max_particles = int(max_particles)
        self.min_distance = int(min_distance)
        self.n_sigma = float(n_sigma)
        self.smooth_sigma = float(smooth_sigma)
        self.engine = None
        self._coords = None
        if piv_config is not None:
            if tuple(piv_config.frame_shape) != self.frame_shape:
                raise ValueError("piv_config.frame_shape "
                                 f"{piv_config.frame_shape} != PTV frame "
                                 f"shape {self.frame_shape}")
            self.engine = MultipassPIV(piv_config, device=self._device,
                                       frame_mask=mask)
            w, o = piv_config.pass_schedule()[-1]
            self._coords = get_coordinates(self.frame_shape, w, o)
        # with a predictor only the residual must fit in the radius
        self.search_radius = float(search_radius if search_radius is not None
                                   else (4.0 if self.engine is not None else 10.0))

    @property
    def device(self) -> torch.device:
        return self._device

    def detect(self, frames: torch.Tensor):
        """Both frames ``[2, H, W]`` in one batched call -> per frame the
        ``(x, y)`` numpy positions of the valid detections outside the
        mask."""
        xs, ys, _, valid = detect_particles(
            frames, self.max_particles, self.min_distance,
            n_sigma=self.n_sigma, smooth_sigma=self.smooth_sigma)
        if self.frame_mask is not None:
            H, W = self.frame_shape
            iy = torch.round(ys).to(torch.int64).clamp(0, H - 1)
            ix = torch.round(xs).to(torch.int64).clamp(0, W - 1)
            valid = valid & ~self.frame_mask[iy, ix]
        xs, ys, valid = (t.cpu().numpy() for t in (xs, ys, valid))
        return [(xs[i][valid[i]], ys[i][valid[i]]) for i in range(frames.shape[0])]

    def _predictor(self, frame_a, frame_b, xa, ya):
        """Per-particle (u, v) prediction from the PIV field."""
        from scipy.interpolate import RegularGridInterpolator

        u, v, inval = self.engine(frame_a, frame_b)
        u = u.cpu().numpy().astype(np.float64)
        v = v.cpu().numpy().astype(np.float64)
        bad = (np.zeros(u.shape, bool) if inval is None
               else inval.cpu().numpy().astype(bool))
        if bad.any():  # predictor only: a median fill is plenty
            u = np.where(bad, np.median(u[~bad]) if (~bad).any() else 0.0, u)
            v = np.where(bad, np.median(v[~bad]) if (~bad).any() else 0.0, v)
        gx, gy = self._coords
        interp_u = RegularGridInterpolator(
            (gy[:, 0], gx[0, :]), u, bounds_error=False, fill_value=None)
        interp_v = RegularGridInterpolator(
            (gy[:, 0], gx[0, :]), v, bounds_error=False, fill_value=None)
        pts = np.column_stack([ya, xa])
        return interp_u(pts), interp_v(pts)

    def _temporal_predictor(self, prev: PTVResult, xa, ya):
        """Per-particle prediction from the previous pair's tracks: in a
        sequential series the previous pair's endpoints live in THIS
        pair's frame A, so each detection inherits the displacement of
        the nearest previous track (zero where none is close)."""
        from scipy.spatial import cKDTree

        if prev.x.size == 0 or xa.size == 0:
            return None, None
        ends = np.column_stack([prev.x + prev.u, prev.y + prev.v])
        tree = cKDTree(ends)
        # inherit from tracks up to ~2 typical particle spacings away —
        # the velocity field is smooth on that scale even when the
        # match radius itself is tight
        if ends.shape[0] > 1:
            dnn, _ = tree.query(ends, k=2)
            spacing = float(np.median(dnn[:, 1]))
        else:
            spacing = 3 * self.search_radius
        bound = max(3 * self.search_radius, 2 * spacing)
        d, j = tree.query(np.column_stack([xa, ya]),
                          distance_upper_bound=bound)
        ok = np.isfinite(d)
        pu = np.where(ok, prev.u[np.minimum(j, prev.u.size - 1)], 0.0)
        pv = np.where(ok, prev.v[np.minimum(j, prev.v.size - 1)], 0.0)
        return pu, pv

    @torch.no_grad()
    def forward(self, frame_a, frame_b, prev: Optional[PTVResult] = None) -> PTVResult:
        a = torch.as_tensor(frame_a).to(self.device)
        b = torch.as_tensor(frame_b).to(self.device)
        (xa, ya), (xb, yb) = self.detect(torch.stack([a, b]))
        pu = pv = None
        if self.engine is not None and xa.size:
            pu, pv = self._predictor(a, b, xa, ya)
        elif prev is not None and xa.size:
            pu, pv = self._temporal_predictor(prev, xa, ya)
        ia, ib, dist = match_particles(xa, ya, xb, yb, pu, pv,
                                       radius=self.search_radius)
        return PTVResult(
            x=xa[ia], y=ya[ia],
            u=xb[ib] - xa[ia], v=yb[ib] - ya[ia],
            residual=dist,
            n_a=int(xa.size), n_b=int(xb.size),
        )
