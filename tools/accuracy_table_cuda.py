#!/usr/bin/env python3
"""Physical accuracy of the port's engine: bias and RMS error against
known synthetic flows, the counterpart of ``tools/accuracy_table.py``.

Flows (512x512 synthetic particle images, ``utils.synthetic``):

* ``sweep``: uniform displacement with the sub-pixel fraction swept over
  0.0..1.0 px (11 pairs): max |bias| over the sweep is the classic
  peak-locking measure;
* ``shear``: u(y) = 1 + 0.03*y (about 2 px across a 64 px window);
* ``vortex``: solid-body rotation, about 1.9 px at the rim.

Configurations: {gauss3, gauss2d} x {CWS, DEF} x {bilinear, bicubic}, all
2-pass 64->32 px, 50% overlap.  Errors are taken on valid interior
vectors (a 3-vector border ring left out).  ``--smoothing``, ``--rpc`` and
``--rescue`` run the JAX tool's other sections: robust smoothn
post-smoothing, SCC against RPC under stationary-background contamination
and the second-peak fallback's recall.

    python tools/accuracy_table_cuda.py [--device cpu] [--write [--out PATH]]

``--write`` writes the table to ``docs/ACCURACY_CUDA.md`` (or ``--out``).
On the card ``--use-pallas auto`` (the default) runs the resampling
kernels; ``off`` runs the JAX engine's XLA paths as torch ops.  Prints the
card's name and power limit before any number.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torchpiv_tpu_torch.utils.synthetic import particle_pair, shear_flow  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (512, 512)
DENSITY = 0.04
SWEEP = np.arange(0.0, 1.01, 0.1)
DU_DY = 0.03
OMEGA = 0.006
DOC = os.path.join(REPO, "docs", "ACCURACY_CUDA.md")


def vortex_flow(omega: float = OMEGA, cx: float = 256.0, cy: float = 256.0):
    """Solid-body rotation: u = -omega*(y-cy), v = omega*(x-cx)."""

    def disp(xs, ys):
        return -omega * (ys - cy), omega * (xs - cx)

    return disp


class Runner:
    """The engine of a configuration on one device, built once a
    configuration: ``runner(cfg_kw, fa, fb) -> (u, v, invalid, x, y)`` as
    numpy arrays."""

    def __init__(self, device, use_pallas: str = "auto"):
        self.device = device
        self.use_pallas = use_pallas
        self.engines = {}

    def engine(self, **cfg_kw):
        from torchpiv_tpu_torch.config import PIVConfig
        from torchpiv_tpu_torch.models.multipass import MultipassPIV

        key = tuple(sorted(cfg_kw.items()))
        if key not in self.engines:
            kw = dict(frame_shape=SHAPE, wind_size=64, overlap=32, multipass=2,
                      use_pallas=self.use_pallas)
            kw.update(cfg_kw)
            self.engines[key] = MultipassPIV(PIVConfig(**kw), device=self.device)
        return self.engines[key]

    def __call__(self, cfg_kw, fa, fb):
        eng = self.engine(**cfg_kw)
        with torch.no_grad():
            u, v, inval = eng(torch.from_numpy(np.ascontiguousarray(fa)).to(self.device),
                              torch.from_numpy(np.ascontiguousarray(fb)).to(self.device))
        x, y = eng.final_coordinates
        return u.cpu().numpy(), v.cpu().numpy(), inval.cpu().numpy(), x, y


def interior_sel(inval):
    sel = ~inval
    sel[:3] = sel[-3:] = False
    sel[:, :3] = sel[:, -3:] = False
    return sel


def eval_sweep(run: Runner, cfg_kw):
    """Uniform sub-pixel sweep: returns (max |bias| px, mean RMS px)."""
    biases, rmses = [], []
    for i, frac in enumerate(SWEEP):
        d = (2.0 + frac, -1.0)
        fa, fb = particle_pair(SHAPE, displacement=d, density=DENSITY, seed=100 + i)
        u, v, inval, x, y = run(cfg_kw, fa, fb)
        sel = interior_sel(inval)
        eu = u[sel] - d[0]
        ev = v[sel] - d[1]
        biases.append(eu.mean())
        rmses.append(np.sqrt(np.mean(eu**2 + ev**2)))
    return float(np.max(np.abs(biases))), float(np.mean(rmses))


def eval_flow(run: Runner, cfg_kw, flow, truth):
    """Spatially varying flow: returns (|bias| px, RMS px)."""
    fa, fb = particle_pair(SHAPE, displacement=flow, density=DENSITY, seed=400)
    u, v, inval, x, y = run(cfg_kw, fa, fb)
    ut, vt = truth(x, y)
    sel = interior_sel(inval)
    eu = u[sel] - ut[sel]
    ev = v[sel] - vt[sel]
    bias = np.sqrt(eu.mean() ** 2 + ev.mean() ** 2)
    return float(bias), float(np.sqrt(np.mean(eu**2 + ev**2)))


def shear_truth(x, y):
    return 1.0 + DU_DY * y, np.zeros_like(y)


def vortex_truth(x, y):
    return -OMEGA * (y - 256.0), OMEGA * (x - 256.0)


def evaluate(run: Runner, cfg_kw) -> dict:
    pk_bias, pk_rms = eval_sweep(run, cfg_kw)
    sh_bias, sh_rms = eval_flow(run, cfg_kw, shear_flow(1.0, DU_DY), shear_truth)
    vx_bias, vx_rms = eval_flow(run, cfg_kw, vortex_flow(OMEGA), vortex_truth)
    return dict(pk_bias=pk_bias, pk_rms=pk_rms, sh_bias=sh_bias,
                sh_rms=sh_rms, vx_bias=vx_bias, vx_rms=vx_rms)


CONFIGS = [
    (f"{mode}/{interp}/{fit}",
     dict(multipass_mode=mode, cws_interp=interp, subpixel=fit))
    for mode in ("CWS", "DEF")
    for interp in ("bilinear", "bicubic")
    for fit in ("gauss3", "gauss2d")
]

HEADER = (
    "| config (mode/interp/fit) | peak-lock max\\|bias\\| | sweep RMS | "
    "shear bias | shear RMS | vortex bias | vortex RMS |\n"
    "|---|---|---|---|---|---|---|")


def table_row(name: str, m: dict) -> str:
    return (f"| {name} | {m['pk_bias']:.4f} | {m['pk_rms']:.4f} | "
            f"{m['sh_bias']:.4f} | {m['sh_rms']:.4f} | "
            f"{m['vx_bias']:.4f} | {m['vx_rms']:.4f} |")


def eval_table(run: Runner, names=None) -> dict:
    """``evaluate`` of each configuration (of ``names`` where given)."""
    out = {}
    for name, kw in CONFIGS:
        if names and name not in names:
            continue
        t0 = time.time()
        out[name] = evaluate(run, kw)
        print(f"# {name}: {out[name]} ({time.time() - t0:.1f} s)", file=sys.stderr)
    return out


def eval_smoothing(run: Runner, cfg_kw):
    """Effect of robust smoothn post-smoothing (``stats.smoothing``) on the
    spatially varying flows: returns {flow: (raw_rms, smooth_rms)} px."""
    from torchpiv_tpu_torch.stats.smoothing import smooth_vector_field

    flows = {"shear": (shear_flow(1.0, DU_DY), shear_truth),
             "vortex": (vortex_flow(OMEGA), vortex_truth)}
    # well seeded (the table's protocol), and sparse, noisy seeding, where
    # the error is random rather than bias and smoothing pays
    cases = [("", DENSITY, 2.0), ("sparse-", 0.01, 20.0),
             ("verysparse-", 0.005, 30.0)]
    out = {}
    for prefix, dens, noise in cases:
        for name, (flow, truth) in flows.items():
            fa, fb = particle_pair(SHAPE, displacement=flow, density=dens,
                                   noise=noise, seed=400)
            u, v, inval, x, y = run(cfg_kw, fa, fb)
            ut, vt = truth(x, y)
            sel = interior_sel(inval)

            def rms(uu, vv):
                return float(np.sqrt(np.mean((uu[sel] - ut[sel]) ** 2
                                             + (vv[sel] - vt[sel]) ** 2)))

            us, vs = smooth_vector_field(u, v, mask=inval, robust=True)
            out[prefix + name] = (rms(u, v), rms(us, vs))
    return out


def eval_rpc(run: Runner, amps=(0.0, 40.0, 80.0, 120.0), n_seeds: int = 3):
    """SCC against RPC across stationary-background contamination
    amplitudes (``utils.synthetic.contaminated_pair``): returns {amp:
    {corr: (rms, bias)}} px, means over the seeds, uniform displacement
    (3.3, -2.1)."""
    from torchpiv_tpu_torch.utils.synthetic import contaminated_pair

    d = (3.3, -2.1)
    out = {}
    for amp in amps:
        out[amp] = {}
        for corr in ("scc", "rpc"):
            errs, biases = [], []
            for i in range(n_seeds):
                fa, fb = contaminated_pair(
                    SHAPE, displacement=d, bg_amplitude=amp,
                    density=DENSITY, noise=2.0, seed=500 + i)
                u, v, inval, x, y = run(dict(correlation=corr), fa, fb)
                sel = interior_sel(inval)
                errs.append(np.sqrt(np.mean((u[sel] - d[0]) ** 2
                                            + (v[sel] - d[1]) ** 2)))
                biases.append(abs(np.mean(u[sel]) - d[0]))
            out[amp][corr] = (float(np.mean(errs)), float(np.mean(biases)))
    return out


def glare_pair(d):
    """A pair with a 64x64 strong blob, identical in both frames."""
    rng = np.random.default_rng(7)
    fa, fb = particle_pair(SHAPE, displacement=d, seed=3)
    fa = fa.astype(np.float64)
    fb = fb.astype(np.float64)
    blob = rng.uniform(0, 255, (64, 64))
    for f in (fa, fb):
        f[224:288, 224:288] = 0.55 * f[224:288, 224:288] + 0.9 * blob
    return np.clip(fa, 0, 255).astype(np.uint8), np.clip(fb, 0, 255).astype(np.uint8)


def eval_rescue(run: Runner, n_seeds: int = 8):
    """Second-peak fallback recall and precision: (a) scattered
    noise-induced outliers (sparse seeding and heavy sensor noise,
    ``n_seeds`` seeds); (b) a static glare blob, where the safe answer is
    to rescue nothing.  Uniform displacement (6.0, -4.5) px, outside the
    validation window's exclusion zone."""
    d = (6.0, -4.5)
    base = dict(median_filter="normmedian")

    def run_pair(fa, fb):
        return {k: run(dict(base, second_peak_fallback=k), fa, fb)[:3]
                for k in (False, True)}

    tot = dict(invalid=0, rescued=0, bad=0)
    for seed in range(n_seeds):
        fa, fb = particle_pair(SHAPE, displacement=d, density=0.0035,
                               noise=14.0, seed=seed)
        out = run_pair(fa, fb)
        u0, v0, i0 = out[False]
        u1, v1, i1 = out[True]
        rescued = i0 & ~i1
        err = np.hypot(u1 - d[0], v1 - d[1])
        tot["invalid"] += int(i0.sum())
        tot["rescued"] += int(rescued.sum())
        tot["bad"] += int((rescued & (err > 1.0)).sum())
    out = run_pair(*glare_pair(d))
    glare = dict(invalid=int(out[False][2].sum()),
                 rescued=int((out[False][2] & ~out[True][2]).sum()))
    return tot, glare


def rescue_text(tot, glare) -> str:
    rc = 100 * tot["rescued"] / max(tot["invalid"], 1)
    return (f"noise outliers: invalid {tot['invalid']}, rescued {tot['rescued']} "
            f"({rc:.0f}%), >1 px mistakes {tot['bad']}\n"
            f"coherent glare blob: invalid {glare['invalid']}, rescued "
            f"{glare['rescued']} (0 = correctly left to infill)")


def rpc_text(res) -> str:
    lines = ["| bg amplitude | SCC RMS | SCC bias | RPC RMS | RPC bias |",
             "|---|---|---|---|---|"]
    for amp, row in res.items():
        s, r = row["scc"], row["rpc"]
        lines.append(f"| {amp:.0f} | {s[0]:.4f} | {s[1]:.4f} | {r[0]:.4f} | {r[1]:.4f} |")
    return "\n".join(lines)


def smoothing_text(name: str, res) -> str:
    return "\n".join(f"{name} {flow}: raw RMS {raw:.4f} px -> smoothed {sm:.4f} px "
                     f"({100 * (1 - sm / raw):.0f}% lower)"
                     for flow, (raw, sm) in res.items())


def document(table: str, card: str, use_pallas: str) -> str:
    return (
        "# Physical accuracy of the PyTorch/CUDA port (synthetic flows)\n\n"
        "Produced by `python tools/accuracy_table_cuda.py --write` on "
        f"{card} (`use_pallas=\"{use_pallas}\"`).  All errors in pixels, valid "
        "interior vectors only; flows and protocol in the script docstring "
        "(the same as `tools/accuracy_table.py`'s).  2-pass 64→32 px, 50% "
        "overlap, 512×512 frames, particle density 0.04.\n\n"
        + table + "\n")


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device
    from torchpiv_tpu_torch.utils.scripts import add_device_args

    ap = argparse.ArgumentParser(description="bias and RMS against known flows")
    ap.add_argument("--write", action="store_true",
                    help="write the table to docs/ACCURACY_CUDA.md (or --out)")
    ap.add_argument("--out", default=DOC, help="where --write writes")
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of config names")
    ap.add_argument("--smoothing", action="store_true",
                    help="measure the smoothn post-smoothing effect only")
    ap.add_argument("--rpc", action="store_true",
                    help="measure SCC against RPC under stationary-background "
                         "contamination only")
    ap.add_argument("--rescue", action="store_true",
                    help="measure second-peak-fallback recall/precision only")
    args = add_device_args(ap).parse_args(argv)
    device, card = script_device(args.device)
    print(card, flush=True)
    run = Runner(device, args.use_pallas)
    if args.rescue:
        print(rescue_text(*eval_rescue(run)))
        return 0
    if args.rpc:
        print(rpc_text(eval_rpc(run)))
        return 0
    if args.smoothing:
        name, kw = CONFIGS[0]  # the reference's mode
        print(smoothing_text(name, eval_smoothing(run, kw)))
        return 0
    res = eval_table(run, args.configs.split(",") if args.configs else None)
    table = HEADER + "\n" + "\n".join(table_row(n, m) for n, m in res.items())
    print(table)
    if args.write:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(document(table, card, args.use_pallas))
        print(f"wrote {os.path.normpath(args.out)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
