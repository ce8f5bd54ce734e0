#!/usr/bin/env python3
"""Post-processing tour on the port: the analysis suite on one synthetic
dataset (the counterpart of ``examples/postprocess_demo.py``).

    python examples/postprocess_demo_cuda.py [output_dir] [--device cpu]

Synthesizes a time-varying vortex sequence, analyzes it with the 2-pass
CWS engine on the CUDA card, then drives the post-processing stack:

* robust smoothn field smoothing (``stats.smooth_vector_field``)
* swirling-strength vortex detection (``stats.derived_fields``)
* per-vector uncertainty map (``stats.uncertainty_map``, on the device)
* snapshot POD mode energies (``stats.compute_pod``)

and renders a 4-panel summary figure (``postprocess_demo.png``, where
matplotlib is installed): velocity magnitude with streamlines, signed
vorticity, swirling strength and the POD energy distribution.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIZE = 512
N_SNAPSHOTS = 6


def run(device, use_pallas: str = "auto") -> dict:
    """The engine and the post-processing; returns the last snapshot's
    smoothed field and its maps, the uncertainty, the POD and the printed
    numbers (``median_uncertainty`` px, ``pod_energy0``)."""
    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models.multipass import MultipassPIV
    from torchpiv_tpu_torch.stats import (compute_pod, derived_fields,
                                          smooth_vector_field, uncertainty_map)
    from torchpiv_tpu_torch.utils.scripts import vortex_flow
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    H = W = SIZE
    cfg = PIVConfig(frame_shape=(H, W), wind_size=64, overlap=32, multipass=2,
                    multipass_mode="CWS", use_pallas=use_pallas)
    engine = MultipassPIV(cfg, device=device)
    print("analyzing a wandering-vortex sequence ...")
    us, vs, raw, last = [], [], [], None
    for i in range(N_SNAPSHOTS):
        cx = W / 2 + 25 * np.sin(0.9 * i)  # the vortex core wanders in time
        cy = H / 2 + 25 * np.cos(0.9 * i)
        fa, fb = particle_pair((H, W), displacement=vortex_flow(cx, cy),
                               seed=100 + i, density=0.03)
        with torch.no_grad():
            u, v, inval = (t.cpu().numpy() for t in engine(
                torch.from_numpy(fa).to(device), torch.from_numpy(fb).to(device)))
        raw.append((u, v, inval))
        u, v = smooth_vector_field(u, v, mask=inval, robust=True)
        us.append(u)
        vs.append(v)
        last = (fa, fb, u, v)
    fa, fb, u, v = last
    x, y = engine.final_coordinates
    step = float(x[0, 1] - x[0, 0])
    maps = derived_fields(u, v, dx=step, dy=step)
    su, sv = uncertainty_map(fa, fb, wind_size=64, overlap=32, device=device)
    pod = compute_pod(np.stack(us), np.stack(vs), n_modes=6)
    return {"x": x, "y": y, "u": u, "v": v, "maps": maps, "raw": raw,
            "median_uncertainty": float(np.nanmedian(np.hypot(su, sv))), "pod": pod,
            "pod_energy0": float(pod.energy_fraction[0])}


def figure(out: dict, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x, y, u, v, maps = out["x"], out["y"], out["u"], out["v"], out["maps"]
    fig, axes = plt.subplots(2, 2, figsize=(11, 9.5), dpi=110)
    (ax_f, ax_w), (ax_s, ax_p) = axes
    im = ax_f.pcolormesh(x, y, np.hypot(u, v), cmap="viridis", shading="auto")
    ax_f.streamplot(x[0], y[:, 0], u, v, color="white", density=1.1,
                    linewidth=0.7, arrowsize=0.8)
    ax_f.set_title("velocity magnitude + streamlines (smoothed)")
    fig.colorbar(im, ax=ax_f, label="|V| [px]")
    wmax = np.abs(maps["vorticity"]).max()
    im = ax_w.pcolormesh(x, y, maps["vorticity"], cmap="RdBu_r", vmin=-wmax,
                         vmax=wmax, shading="auto")
    ax_w.set_title("vorticity (diverging, zero at midpoint)")
    fig.colorbar(im, ax=ax_w, label="ω [1/px]")
    im = ax_s.pcolormesh(x, y, maps["swirling_strength"], cmap="magma", shading="auto")
    ax_s.set_title("swirling strength λ_ci (vortex detector)")
    fig.colorbar(im, ax=ax_s, label="λ_ci [1/px]")
    frac = out["pod"].energy_fraction
    ax_p.bar(np.arange(len(frac)), 100 * frac, color="#4c78a8", width=0.7)
    ax_p.set_xlabel("POD mode")
    ax_p.set_ylabel("energy [%]")
    ax_p.set_title("snapshot POD energy distribution")
    ax_p.spines[["top", "right"]].set_visible(False)
    ax_p.grid(axis="y", alpha=0.25)
    for a in (ax_f, ax_w, ax_s):
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
    print(f"median uncertainty {out['median_uncertainty']:.3f} px; "
          f"POD mode-0 energy {out['pod_energy0']:.0%}")
    if have_matplotlib():
        path = os.path.join(args.out_dir, "postprocess_demo.png")
        figure(out, path)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
