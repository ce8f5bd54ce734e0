#!/usr/bin/env python3
"""Dense against correlation on a shear flow, on the port (the counterpart
of ``examples/dense_demo.py``).

    python examples/dense_demo_cuda.py [output_dir] [--device cpu]

Analyses one synthetic shear pair three ways on the CUDA card: 2-pass CWS
correlation, plain dense LK (``models.FolkiPIV``) and the
correlation-anchored hybrid, and renders the error maps side by side with
their RMS numbers (``dense_demo.png``, where matplotlib is installed).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIZE = 512
NAMES = ("correlation (2-pass CWS)", "dense LK", "hybrid (corr-anchored LK)")


def run(device, use_pallas: str = "auto") -> dict:
    """The three analyses; returns the grid and, by name, ``(u, usable
    mask)`` on it with the u-error RMS in px (``rms``)."""
    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models import FolkiPIV
    from torchpiv_tpu_torch.utils.synthetic import particle_pair, shear_flow

    H = W = SIZE
    fa, fb = particle_pair((H, W), displacement=shear_flow(1.0, 0.03), seed=11,
                           density=0.04)
    cfg = PIVConfig(frame_shape=(H, W), wind_size=64, overlap=32, multipass=2,
                    multipass_mode="CWS", use_pallas=use_pallas)
    plain = FolkiPIV((H, W), wind_size=32, overlap=16, device=device)
    hybrid = FolkiPIV((H, W), wind_size=32, overlap=16, piv_config=cfg, device=device)
    corr = hybrid.engine  # one engine serves both panels
    gx, gy = plain.coordinates
    tru = 1.0 + 0.03 * gy
    inner = np.zeros(gx.shape, bool)
    inner[3:-3, 3:-3] = True
    with torch.no_grad():
        uc, vc, bc = (t.cpu().numpy() for t in corr(
            torch.from_numpy(fa).to(device), torch.from_numpy(fb).to(device)))
    up, vp, bp = plain(fa, fb)
    uh, vh, bh = hybrid(fa, fb)
    fields = {NAMES[0]: (uc, inner & (bc == 0)), NAMES[1]: (up, inner & ~bp),
              NAMES[2]: (uh, inner)}
    rms = {}
    for name, (u, ok) in fields.items():
        err = np.where(ok, u - tru, np.nan)
        rms[name] = float(np.sqrt(np.nanmean(err ** 2)))
    return {"gx": gx, "gy": gy, "truth": tru, "fields": fields, "rms": rms}


def figure(out: dict, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.6), dpi=110)
    for ax, name in zip(axes, NAMES):
        u, ok = out["fields"][name]
        err = np.where(ok, u - out["truth"], np.nan)
        im = ax.pcolormesh(out["gx"], out["gy"], err, cmap="RdBu_r", vmin=-0.1,
                           vmax=0.1, shading="auto")
        ax.set_title(f"{name}\nu-error RMS {out['rms'][name]:.4f} px")
        ax.set_aspect("equal")
        ax.invert_yaxis()
    fig.colorbar(im, ax=axes, label="u error [px]", fraction=0.02)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device
    from torchpiv_tpu_torch.utils.scripts import example_args, have_matplotlib

    args = example_args(argv, __doc__)
    device, card = script_device(args.device)
    print(card, flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    out = run(device, args.use_pallas)
    for name in NAMES:
        print(f"{name}: {out['rms'][name]:.4f} px RMS")
    if have_matplotlib():
        path = os.path.join(args.out_dir, "dense_demo.png")
        figure(out, path)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
