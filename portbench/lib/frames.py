"""Synthetic PIV frame pairs made on the device from the seed: Gaussian
particle images in frame A, advected by a known flow and rendered again in
frame B, on a constant background with Gaussian sensor noise, clipped and
truncated to 8 bits.  The arithmetic is that of the program's NumPy
generator (``utils/synthetic.py``: ``render_particles``,
``particle_pair``), rewritten in torch and drawn from one
``torch.Generator`` in a few large calls.

The flow is a uniform displacement plus a Lamb-Oseen vortex whose centre is
drawn for each pair; every pair has the same number of particles, so every
seed gives the same amount of work.  The same seed on the same device and
torch build gives the same bytes: the particle stamps are summed in fixed
point (2**-32 of a grey level), so the order of the device's additions
does not matter.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

FIXED = float(1 << 32)  # the stamps' fixed-point scale


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def flow(params: dict, xs: torch.Tensor, ys: torch.Tensor, centre):
    """``(u, v)`` in pixels at particle positions: ``uniform`` plus a
    Lamb-Oseen vortex of ``peak_swirl`` px at radius 1.1209 ``core_radius``
    (the radius of the largest swirl), counter-clockwise in image axes."""
    u0, v0 = params.get("uniform", (0.0, 0.0))
    u = torch.full_like(xs, float(u0))
    v = torch.full_like(xs, float(v0))
    vortex = params.get("vortex")
    if vortex:
        rc = float(vortex["core_radius"])
        # u_theta(r) = G / (2 pi r) (1 - exp(-r^2 / rc^2)); its maximum,
        # at r = 1.12091 rc, is 0.638161 G / (2 pi rc)
        circ = float(vortex["peak_swirl"]) * 2 * math.pi * rc / 0.638161
        dx = xs - centre[:, None, 0]
        dy = ys - centre[:, None, 1]
        r2 = (dx * dx + dy * dy).clamp(min=1e-12)
        ut_over_r = circ / (2 * math.pi * r2) * (1 - torch.exp(-r2 / (rc * rc)))
        u = u - ut_over_r * dy
        v = v + ut_over_r * dx
    return u, v


def render(shape: Tuple[int, int], xs, ys, inten, diameter: float) -> torch.Tensor:
    """Additive Gaussian particle images ``[P, H, W]`` (float64) of ``[P,
    n]`` particles, each a separable stamp of radius ``max(2, ceil(3
    sigma))`` around its nearest pixel; stamp pixels off the frame add
    nothing."""
    H, W = shape
    P, n = xs.shape
    dev = xs.device
    sigma = diameter / 2.354
    r = max(2, int(math.ceil(3 * sigma)))
    span = torch.arange(-r, r + 1, device=dev, dtype=torch.float64)
    cx, cy = torch.round(xs), torch.round(ys)
    gx = torch.exp(-((span - (xs - cx)[..., None]) ** 2) / (2 * sigma ** 2))
    gy = torch.exp(-((span - (ys - cy)[..., None]) ** 2) / (2 * sigma ** 2))
    stamps = inten[..., None, None] * gy[..., :, None] * gx[..., None, :]
    iy = cy.long()[..., None] + span.long()
    ix = cx.long()[..., None] + span.long()
    ok = ((iy >= 0) & (iy < H))[..., :, None] & ((ix >= 0) & (ix < W))[..., None, :]
    flat = (iy.clamp(0, H - 1)[..., :, None] * W + ix.clamp(0, W - 1)[..., None, :])
    flat = flat + (torch.arange(P, device=dev) * (H * W))[:, None, None, None]
    # fixed point, so that the sum does not depend on the order in which
    # the device adds: integer addition is exact
    fixed = torch.round(torch.where(ok, stamps, 0.0) * FIXED).long()
    out = torch.zeros(P * H * W, dtype=torch.int64, device=dev)
    out.scatter_add_(0, flat.reshape(-1), fixed.reshape(-1))
    return (out.to(torch.float64) / FIXED).reshape(P, H, W)


def pairs(n_pairs: int, shape: Tuple[int, int], traffic: dict, seed: int, device,
          chunk: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_pairs`` uint8 pairs ``[n, H, W]`` on ``device`` from ``seed`` and
    the mix's ``particles`` and ``flow`` groups."""
    H, W = shape
    p = traffic["particles"]
    f = traffic["flow"]
    g = generator(seed, device)
    n = int(p["density"] * H * W)
    m = float(p.get("margin", 16))
    lo, hi = p.get("intensity", (100.0, 220.0))
    box = f.get("vortex", {}).get("centre_box", (0.25, 0.75))
    outs_a, outs_b = [], []
    for s in range(0, n_pairs, chunk):
        P = min(chunk, n_pairs - s)
        kw = dict(generator=g, device=device, dtype=torch.float64)
        xs = torch.rand((P, n), **kw) * (W + 2 * m) - m
        ys = torch.rand((P, n), **kw) * (H + 2 * m) - m
        inten = torch.rand((P, n), **kw) * (hi - lo) + lo
        centre = torch.rand((P, 2), **kw) * (box[1] - box[0]) + box[0]
        centre = centre * torch.tensor([W, H], device=device, dtype=torch.float64)
        u, v = flow(f, xs, ys, centre)
        frames = []
        for X, Y in ((xs, ys), (xs + u, ys + v)):
            img = render((H, W), X, Y, inten, float(p["diameter"]))
            img += float(p["background"]) + torch.randn((P, H, W), **kw) * float(p["noise"])
            frames.append(img.clamp_(0, 255).to(torch.uint8))
            del img
        outs_a.append(frames[0])
        outs_b.append(frames[1])
    return torch.cat(outs_a), torch.cat(outs_b)
