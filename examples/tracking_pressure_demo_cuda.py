#!/usr/bin/env python3
"""Tracking and pressure on the port, on one synthetic flow (the
counterpart of ``examples/tracking_pressure_demo.py``).

    python examples/tracking_pressure_demo_cuda.py [output_dir] [--device cpu]

Synthesizes a vortex particle pair, then drives:

* PIV-guided particle tracking on the CUDA card (``models.PTV``):
  scattered per-particle vectors with the correlation field as predictor
* track binning onto the PIV grid (``models.bin_to_grid``)
* Gamma1 vortex-center identification (``stats.gamma_functions``)
* pressure reconstruction (``stats.pressure_poisson``)

and renders a 3-panel figure (``tracking_pressure_demo.png``, where
matplotlib is installed): the tracks colored by speed, Gamma1 with the
detected core marked, and the recovered gauge pressure (low at the vortex
core: the physics sanity check).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402

SIZE = 512


def run(device, use_pallas: str = "auto") -> dict:
    """Tracking, binning, Gamma1 and pressure; returns the tracks
    (``res``), the grid maps and the printed numbers."""
    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models import PTV, bin_to_grid
    from torchpiv_tpu_torch.stats import gamma_functions, pressure_poisson
    from torchpiv_tpu_torch.utils.scripts import vortex_flow
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    H = W = SIZE
    fa, fb = particle_pair((H, W), displacement=vortex_flow(W / 2, H / 2), seed=7,
                           density=0.01)
    print("tracking particles (PIV-guided) ...")
    cfg = PIVConfig(frame_shape=(H, W), wind_size=64, overlap=32, multipass=2,
                    multipass_mode="CWS", use_pallas=use_pallas)
    res = PTV((H, W), piv_config=cfg, max_particles=4096, device=device)(fa, fb)
    gx, gy, gu, gv, _ = bin_to_grid(res.x, res.y, res.u, res.v, (H, W),
                                    wind_size=32, overlap=16)
    gu = np.nan_to_num(gu)
    gv = np.nan_to_num(gv)
    step = float(gx[0, 1] - gx[0, 0])
    g1, _ = gamma_functions(gu, gv, dx=step, dy=step, radius=3)
    core = np.unravel_index(np.argmax(np.abs(g1)), g1.shape)
    p = pressure_poisson(gu, gv, dx=step, dy=step, rho=1.0)
    return {"res": res, "gx": gx, "gy": gy, "g1": g1, "p": p,
            "core": tuple(int(c) for c in core), "gamma1_core": float(abs(g1[core])),
            "p_core": float(p[core]), "p_min": float(p.min())}


def figure(out: dict, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    res, gx, gy, core = out["res"], out["gx"], out["gy"], out["core"]
    fig, (ax_t, ax_g, ax_p) = plt.subplots(1, 3, figsize=(16, 5), dpi=110)
    speed = np.hypot(res.u, res.v)
    # u/v are image-convention; the axes are inverted to image coordinates
    # below, so the arrow components pass through unchanged
    sc = ax_t.quiver(res.x, res.y, res.u, res.v, speed, cmap="viridis",
                     angles="xy", scale_units="xy", scale=0.25, width=0.003)
    ax_t.set_title(f"PTV tracks ({res.x.size} particles)")
    fig.colorbar(sc, ax=ax_t, label="|d| [px]")
    im = ax_g.pcolormesh(gx, gy, out["g1"], cmap="RdBu_r", vmin=-1, vmax=1,
                         shading="auto")
    ax_g.plot(gx[core], gy[core], "k+", ms=14, mew=2)
    ax_g.set_title("Gamma1 vortex-center function")
    fig.colorbar(im, ax=ax_g, label="Γ1 [-]")
    im = ax_p.pcolormesh(gx, gy, out["p"], cmap="magma", shading="auto")
    ax_p.plot(gx[core], gy[core], "c+", ms=14, mew=2)
    ax_p.set_title("gauge pressure (Poisson from tracks)")
    fig.colorbar(im, ax=ax_p, label="p [arb]")
    for a in (ax_t, ax_g, ax_p):
        a.set_aspect("equal")
        a.invert_yaxis()  # image coordinates
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device
    from torchpiv_tpu_torch.utils.scripts import example_args, have_matplotlib

    args = example_args(argv, __doc__)
    device, card = script_device(args.device)
    print(card, flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    out = run(device, args.use_pallas)
    res = out["res"]
    print(f"{res.n_a} particles detected, {res.x.size} tracked "
          f"({res.x.size / max(res.n_a, 1):.0%})")
    print(f"Gamma1 core at grid {out['core']}, |Gamma1| {out['gamma1_core']:.2f}")
    print(f"pressure at core {out['p_core']:.4g} (field min {out['p_min']:.4g}) — "
          f"vortex core must be the low-pressure region")
    if have_matplotlib():
        path = os.path.join(args.out_dir, "tracking_pressure_demo.png")
        figure(out, path)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
