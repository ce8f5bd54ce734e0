#!/usr/bin/env python3
"""Camera-degraded validation campaign on the port: the counterpart of
``tools/degraded_campaign.py``.  ``OfflinePIV`` runs a controlled degraded
dataset (``camera_degraded_pair``: out-of-plane dropout, vignetting,
stationary glare, shot and read noise, hot pixels) whose true flow is
known, in several configurations, and the tool prints a markdown table and
writes it with a JSON artifact per tier.

    python tools/degraded_campaign_cuda.py [--size 512] [--pairs 6]
        [--tier moderate|harsh|all] [--out-dir docs/campaign_cuda]
        [--device cpu]

Each tier writes ``<tier>.json`` and ``<tier>.md`` into ``--out-dir``.
The JAX tool's reference column (the upstream TorchPIV ``OfflinePIV`` on
the CPU, from a checkout outside this repository) is left out, as the JAX
tool leaves it out where that checkout is missing.  Prints the card's
name and power limit before any number.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "docs", "campaign_cuda")
TRUE_U, TRUE_V = 3.3, -2.1  # px, image coordinates
# physical output with dt=1000 us, scale=1 mm/px: u_phys = u_px, and the
# pipeline's tail flips the y axis (v_phys = -v_px)
EXPECT_U, EXPECT_V = TRUE_U, -TRUE_V

TIERS = {
    # a good lab recording: mild but realistic camera effects
    "moderate": dict(density=0.012, dropout=0.15, intensity_flicker=0.25,
                     vignette=0.55, glare_amplitude=45.0, read_noise=4.0,
                     shot_noise=True, hot_pixel_rate=3e-5),
    # a bad day: sparse seeding, heavy out-of-plane loss, strong glare, so
    # that windows fail validation and the recovery machinery has work
    "harsh": dict(density=0.005, dropout=0.25, intensity_flicker=0.4,
                  vignette=0.7, glare_amplitude=90.0, read_noise=6.0,
                  shot_noise=True, hot_pixel_rate=1e-4),
}
# OfflinePIV's settings for every row (fields in px)
RUN = dict(file_fmt=".bmp", wind_size=64, overlap=32, multipass=2,
           multipass_mode="CWS", dt=1000.0, scale=1.0, folder_mode="pairs")
CONFIGS = [
    ("tpiv SCC (same settings)", {}),
    ("tpiv SCC + preprocess=clahe", {"preprocess": "clahe"}),
    ("tpiv SCC + background=auto", {"background": "auto"}),
    ("tpiv RPC", {"engine_options": {"correlation": "rpc"}}),
    ("tpiv SCC + second-peak fallback",
     {"engine_options": {"second_peak_fallback": True}}),
    ("tpiv RPC + clahe + fallback",
     {"preprocess": "clahe",
      "engine_options": {"correlation": "rpc", "second_peak_fallback": True}}),
]


def make_dataset(folder: str, size: int, n_pairs: int, tier: str,
                 threads: int = 4) -> None:
    """``n_pairs`` pairs of ``tier`` at ``size`` x ``size``, seeds 100 on,
    written as BMP files in threads."""
    from torchpiv_tpu_torch.io.decode import imwrite_gray
    from torchpiv_tpu_torch.utils.synthetic import camera_degraded_pair

    os.makedirs(folder, exist_ok=True)

    def one(i):
        fa, fb = camera_degraded_pair((size, size), displacement=(TRUE_U, TRUE_V),
                                      seed=100 + i, **TIERS[tier])
        imwrite_gray(os.path.join(folder, f"d{i:03d}_a.bmp"), fa)
        imwrite_gray(os.path.join(folder, f"d{i:03d}_b.bmp"), fb)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, range(n_pairs)))


def field_metrics(fields: list) -> dict:
    """Accuracy of yielded ``(x, y, u, v)`` fields against the known
    uniform flow: ``bad`` is the share of vectors more than 1 px off (the
    infilled outliers and wrong peak locks), ``rms_good_px`` the RMS error
    of the rest, ``rms_all_px`` that of all."""
    errs = [np.sqrt((np.asarray(u, np.float64) - EXPECT_U) ** 2
                    + (np.asarray(v, np.float64) - EXPECT_V) ** 2).ravel()
            for _, _, u, v in fields]
    e = np.concatenate(errs) if errs else np.array([np.nan])
    bad = e > 1.0
    return {
        "pairs_yielded": len(fields),
        "bad_pct": round(100.0 * float(bad.mean()), 2),
        "rms_good_px": round(float(np.sqrt(np.mean(e[~bad] ** 2))), 4)
        if (~bad).any() else float("nan"),
        "rms_all_px": round(float(np.sqrt(np.mean(e ** 2))), 3),
    }


def offline(folder: str, device: str = "cuda", use_pallas: str = "auto", **extra):
    """The port's ``OfflinePIV`` over ``folder`` with the campaign's
    settings, ``extra`` keywords and ``use_pallas``."""
    from torchpiv_tpu_torch.pipeline import OfflinePIV

    kw = dict(RUN, device=device, **extra)
    kw["engine_options"] = {"use_pallas": use_pallas, **extra.get("engine_options", {})}
    return OfflinePIV(folder, **kw)


def run_ours(folder: str, device: str = "cuda", use_pallas: str = "auto",
             **extra) -> dict:
    """One row: ``field_metrics`` of the fields and the wall seconds."""
    t0 = time.perf_counter()
    fields = list(offline(folder, device, use_pallas, **extra)())
    m = field_metrics(fields)
    m["wall_s"] = round(time.perf_counter() - t0, 3)
    return m


def table(rows: dict) -> str:
    lines = ["| engine / config | pairs | bad vectors | RMS (good) px | "
             "RMS (all) px | wall s |", "|---|---|---|---|---|---|"]
    for name, m in rows.items():
        lines.append(f"| {name} | {m['pairs_yielded']} | {m['bad_pct']}% | "
                     f"{m['rms_good_px']} | {m['rms_all_px']} | {m['wall_s']} |")
    return "\n".join(lines)


def campaign(tier: str, size: int, n_pairs: int, device: str, use_pallas: str = "auto",
             keep: bool = False) -> dict:
    """Every row of one tier; returns ``{name: metrics}``."""
    folder = tempfile.mkdtemp(prefix=f"tpiv_degraded_cuda_{tier}_{size}_{n_pairs}_")
    print(f"dataset: {n_pairs} degraded ({tier}) {size}x{size} pairs -> {folder}",
          file=sys.stderr)
    try:
        make_dataset(folder, size, n_pairs, tier)
        rows = {}
        for name, extra in CONFIGS:
            print(f"running {name}...", file=sys.stderr)
            rows[name] = run_ours(folder, device, use_pallas, **extra)
        return rows
    finally:
        if not keep:
            shutil.rmtree(folder, ignore_errors=True)


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device
    from torchpiv_tpu_torch.utils.scripts import add_device_args

    ap = argparse.ArgumentParser(description="camera-degraded campaign on the port")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--tier", default="moderate", choices=sorted(TIERS) + ["all"])
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where <tier>.json and <tier>.md go")
    ap.add_argument("--keep", action="store_true", help="keep the dataset")
    args = add_device_args(ap).parse_args(argv)
    device, card = script_device(args.device)
    print(card, flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    for tier in (sorted(TIERS) if args.tier == "all" else [args.tier]):
        rows = campaign(tier, args.size, args.pairs, str(device), args.use_pallas,
                        args.keep)
        text = table(rows)
        print(f"## {tier}\n{text}")
        payload = {"tier": tier, "degrade": TIERS[tier], "size": args.size,
                   "pairs": args.pairs, "true_flow_px": [TRUE_U, TRUE_V],
                   "device": str(device), "card": card,
                   "use_pallas": args.use_pallas, "rows": rows}
        with open(os.path.join(args.out_dir, f"{tier}.json"), "w") as f:
            json.dump(payload, f, indent=1)
        with open(os.path.join(args.out_dir, f"{tier}.md"), "w") as f:
            f.write(f"# Camera-degraded campaign, {tier} tier\n\n"
                    f"`python tools/degraded_campaign_cuda.py --tier {tier} --size "
                    f"{args.size} --pairs {args.pairs}` on {card} "
                    f"(`use_pallas=\"{args.use_pallas}\"`); true flow "
                    f"({TRUE_U}, {TRUE_V}) px.\n\n{text}\n")
        print(f"wrote {args.out_dir}/{tier}.json and {tier}.md", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
