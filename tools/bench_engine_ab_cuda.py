#!/usr/bin/env python3
"""A/B the port's engine between ``PIVConfig`` settings on one CUDA card:
the counterpart of ``tools/bench_engine_ab.py``.

    python tools/bench_engine_ab_cuda.py off split
    python tools/bench_engine_ab_cuda.py correlator=matmul,dft_precision=default fused=auto
    python tools/bench_engine_ab_cuda.py --device cpu off split

Times the headline configuration (4 MP pairs, w64/o32, 2 passes,
``AB_MODE``, default CWS) at a batch of ``AB_BATCH`` (default 8) pairs
staged on the device, for each setting given, and reports the field
agreement between the first two.  A setting is a bare ``fused`` value
(off / split / on) or comma-separated ``key=value`` ``PIVConfig``
overrides, passed as strings as the JAX tool passes them.  The engine is
the port's batched ``MultipassPIV.forward`` (the JAX tool's ``lax.scan``
over pairs); each setting's time is the best of 3 dispatches, each between
two ``torch.cuda.synchronize``, after a first call whose seconds go to
standard error.

Prints the card's name and power limit first, then one line a setting and
the agreement line: the share of windows whose invalid flags agree, and
the largest and the RMS ``|du|``, ``|dv|`` on windows valid in both.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME = (2048, 2048)
BATCH = int(os.environ.get("AB_BATCH", 8))
MODE = os.environ.get("AB_MODE", "CWS")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse_setting(s: str) -> dict:
    """Bare word -> {"fused": word}; "k=v,k2=v2" -> override dict."""
    if "=" not in s:
        return {"fused": s}
    out = {}
    for kv in s.split(","):
        k, v = kv.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def build(setting: str, device, frame=FRAME, mode=MODE):
    """The engine of one setting on ``device``."""
    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models.multipass import MultipassPIV

    cfg = PIVConfig(frame_shape=tuple(frame), wind_size=64, overlap=32, multipass=2,
                    multipass_mode=mode, **parse_setting(setting))
    return MultipassPIV(cfg, device=device)


def unique_pairs(frame, n: int = 4) -> list:
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    return [particle_pair(frame, displacement=(3.3, -2.1), density=0.01, seed=i)
            for i in range(n)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fields(engine, fa, fb):
    """``(u, v, invalid)`` of the batch on the host; ``invalid`` all False
    where the engine does not validate."""
    u, v, inval = engine(fa, fb)
    if inval is None:
        inval = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    return [t.cpu().numpy() for t in (u, v, inval)]


def run_setting(setting: str, device, fa, fb, frame=FRAME, mode=MODE) -> dict:
    """One setting: its first call's seconds, the best of 3 dispatches and
    its fields; prints the JAX tool's line."""
    engine = build(setting, device, frame, mode)
    batch = fa.shape[0]
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        out = fields(engine, fa, fb)
        first_s = time.perf_counter() - t0
        log(f"{setting}: compile+first {first_s:.1f} s")
        best = np.inf
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            engine(fa, fb)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
    print(f"{setting:6s} {1000 * best / batch:6.2f} ms/pair "
          f"({batch / best:.1f} pairs/s at batch {batch})", flush=True)
    return {"setting": setting, "best_s": best, "ms_pair": 1000 * best / batch,
            "first_s": first_s, "fields": out,
            "final_field_shape": tuple(engine.final_field_shape)}


def agreement(a, b) -> dict:
    """The JAX tool's agreement of two ``(u, v, invalid)`` field sets:
    the share of equal invalid flags, and on windows valid in both the
    largest and the RMS ``|du|``, ``|dv|``."""
    agree = a[2] == b[2]
    both = ~(a[2] | b[2]) & agree
    du = np.abs(a[0] - b[0])[both]
    dv = np.abs(a[1] - b[1])[both]
    return {"mask_agree": float(agree.mean()),
            "du_max": float(du.max()), "du_rms": float(np.sqrt((du ** 2).mean())),
            "dv_max": float(dv.max()), "dv_rms": float(np.sqrt((dv ** 2).mean()))}


def ab(settings, device, frame=FRAME, batch=BATCH, mode=MODE, pairs=None) -> dict:
    """Every setting in turn on the same staged batch; returns
    ``{"runs": [...], "agreement": dict or None}`` and prints the lines."""
    pairs = pairs if pairs is not None else unique_pairs(frame)
    fa, fb = (torch.from_numpy(np.stack([pairs[i % len(pairs)][k]
                                         for i in range(batch)])).to(device)
              for k in (0, 1))
    runs = []
    for s in settings:
        runs.append(run_setting(s, device, fa, fb, frame, mode))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    agreed = None
    if len(runs) >= 2:
        agreed = agreement(runs[0]["fields"], runs[1]["fields"])
        print(f"fields {settings[0]} vs {settings[1]}: mask agree "
              f"{agreed['mask_agree']:.4f}, |du| max {agreed['du_max']:.2e} "
              f"rms {agreed['du_rms']:.2e}, |dv| max {agreed['dv_max']:.2e} "
              f"rms {agreed['dv_rms']:.2e}", flush=True)
    return {"runs": runs, "agreement": agreed}


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings", nargs="*", default=["off", "split"])
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:<i> or cpu; TPIV_DEVICE also names it")
    args = ap.parse_args(argv)
    device, card = script_device(args.device)
    print(card, flush=True)
    log(f"device {device}  mode={MODE}")
    ab(args.settings or ["off", "split"], device, FRAME, BATCH, MODE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
