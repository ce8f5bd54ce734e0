#!/usr/bin/env python3
"""End-to-end demo on the port: synthesize a particle-image sequence, run
the full offline pipeline on the CUDA card, and render the results (the
counterpart of ``examples/demo.py``).

    python examples/demo_cuda.py [output_dir] [--device cpu]

``TPIV_DEVICE=cpu`` also runs it on the CPU.  Produces, in the output
directory:
  frames/              synthetic BMP frame pairs (vortex flow)
  demo_field.png       velocity-magnitude map with streamlines (where
                       matplotlib is installed)
  frames_statistics.txt  the 13-column ensemble statistics table (named
                       after the frames folder by the runner)
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402

SIZE = 512
N_PAIRS = 4


def run(out_dir: str, device, use_pallas: str = "auto") -> dict:
    """The demo's pipeline run; returns the statistics table, the number of
    pairs and the peak speed."""
    from torchpiv_tpu_torch.io.decode import imwrite_gray
    from torchpiv_tpu_torch.pipeline import PIVRunner
    from torchpiv_tpu_torch.utils.config import PIVParams
    from torchpiv_tpu_torch.utils.scripts import vortex_flow
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    frames = os.path.join(out_dir, "frames")
    os.makedirs(frames, exist_ok=True)
    print("generating synthetic vortex frame pairs ...")
    for i in range(N_PAIRS):
        fa, fb = particle_pair((SIZE, SIZE), displacement=vortex_flow(SIZE / 2, SIZE / 2),
                               seed=100 + i, density=0.03)
        imwrite_gray(os.path.join(frames, f"vortex{i:03d}_a.bmp"), fa)
        imwrite_gray(os.path.join(frames, f"vortex{i:03d}_b.bmp"), fb)

    params = PIVParams(
        wind_size=64, overlap=32, multipass=2, multipass_mode="CWS",
        scale=0.05, dt=2.0, device=str(device), file_fmt=".bmp", folder=frames,
        folder_mode="pairs", save_opt="Save statistics", save_dir=out_dir)
    print("running 2-pass CWS analysis ...")
    outputs = []
    runner = PIVRunner(params,
                       on_progress=lambda pct: print(f"\r  progress {pct:3d}%", end=""),
                       on_output=outputs.append,
                       engine_options={"use_pallas": use_pallas})
    table = runner.run()
    print()
    if table is None:
        raise RuntimeError("the runner produced no statistics")
    speed = np.hypot(table["Vx[m/s]"], table["Vy[m/s]"])
    return {"table": table, "pairs": len(outputs), "peak_speed": float(speed.max())}


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device
    from torchpiv_tpu_torch.utils.scripts import example_args, have_matplotlib

    args = example_args(argv, __doc__)
    device, card = script_device(args.device)
    print(card, flush=True)
    out = run(args.out_dir, device, args.use_pallas)
    if have_matplotlib():
        from torchpiv_tpu_torch.gui import viz

        print("rendering ...")
        viz.render_field(out["table"], "Vy[m/s]", streamlines=True,
                         out_path=os.path.join(args.out_dir, "demo_field.png"))
    print(f"processed {out['pairs']} pairs; peak |V| = {out['peak_speed']:.2f} m/s; "
          f"outputs in {os.path.abspath(args.out_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
