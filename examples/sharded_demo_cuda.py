#!/usr/bin/env python3
"""The same PIV analysis sharded over a device mesh, on the port (the
counterpart of ``examples/sharded_demo.py``).

    python examples/sharded_demo_cuda.py [--devices N] [--device cpu]

Shows the two scaling axes of ``parallel.ShardedPIV``:

* ``pairs``: data parallelism over the image-pair batch (no exchange);
* ``windows``: the window grid of each pair split in row blocks (the
  coarse predictor field is gathered between passes).

The mesh is built over ``--devices`` (default 2) entries, with the JAX
demo's rule (``default_piv_mesh``): ``{"pairs": N/2, "windows": 2}`` for
an even N above 2, else ``{"pairs": N}``.  With several CUDA cards it takes
the first N; with one card (or on the CPU) it names that device N times,
and shards on one device run in turn: the run then shows the split's cost,
never a multi-device speed.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SIZE = 512


def mesh_devices(device, n: int) -> list:
    """``n`` mesh entries: the first ``n`` CUDA cards where there are that
    many, else ``device`` named ``n`` times."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def mesh_axes(n: int) -> dict:
    """``default_piv_mesh``'s rule for ``n`` devices."""
    return {"pairs": n // 2, "windows": 2} if n > 2 and n % 2 == 0 else {"pairs": n}


def run(device, n_devices: int = 2, use_pallas: str = "auto") -> dict:
    """The sharded engine over one batch of ``pairs`` synthetic pairs;
    returns the mesh, the fields (numpy, ``[B, R, C]``) and the pairs'
    true u."""
    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models.multipass import MultipassPIV
    from torchpiv_tpu_torch.parallel import ShardedPIV, make_mesh
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    devices = mesh_devices(device, n_devices)
    mesh = make_mesh(mesh_axes(n_devices), devices)
    B = mesh.shape["pairs"]
    pairs = [particle_pair((SIZE, SIZE), displacement=(3.0 + 0.2 * i, -1.5), seed=i)
             for i in range(B)]
    fa = torch.from_numpy(np.stack([p[0] for p in pairs])).to(device)
    fb = torch.from_numpy(np.stack([p[1] for p in pairs])).to(device)
    engine = MultipassPIV(PIVConfig(frame_shape=(SIZE, SIZE), wind_size=64, overlap=32,
                                    multipass=2, multipass_mode="CWS",
                                    use_pallas=use_pallas), device=device)
    with torch.no_grad():
        u, v, invalid = (t.cpu().numpy() for t in ShardedPIV(engine, mesh)(fa, fb))
    return {"mesh": mesh, "devices": devices, "u": u, "v": v, "invalid": invalid,
            "true_u": [3.0 + 0.2 * i for i in range(B)]}


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device
    from torchpiv_tpu_torch.utils.scripts import add_device_args

    ap = argparse.ArgumentParser(description="PIV sharded over a device mesh")
    ap.add_argument("--devices", type=int, default=2, help="mesh entries (>= 2)")
    args = add_device_args(ap).parse_args(argv)
    if args.devices < 2:
        print("need >=2 mesh entries (--devices)", file=sys.stderr)
        return 1
    device, card = script_device(args.device)
    print(card, flush=True)
    out = run(device, args.devices, args.use_pallas)
    distinct = len(set(out["devices"]))
    print(f"devices: {args.devices} ({distinct} distinct: "
          f"{', '.join(str(d) for d in out['devices'])}), mesh: {dict(out['mesh'].shape)}")
    if distinct < args.devices:
        print("one device named several times: the shards run in turn, so this "
              "shows the split's cost, not a multi-device speed")
    u, invalid = out["u"], out["invalid"]
    for i, true_u in enumerate(out["true_u"]):
        sel = ~invalid[i]
        print(f"pair {i}: mean u = {u[i][sel].mean():+.3f} px "
              f"(true {true_u:+.1f}), valid {sel.mean():.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
