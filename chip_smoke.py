#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``torchpiv_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each failing loudly:

1. environment: torch/CUDA versions, the card's name and power limit, TF32
   off;
2. build every CUDA kernel of the package from its sources;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (2048x2048 frames, pass 2: w32/o16, a batch of 4), with
   times: kernel, plain version, bound, and one PyTorch library call that
   computes the same function (``grid_sample``, a yardstick only);
4. the main path: ``OfflinePIV`` over 8 synthetic 2048x2048 BMP pairs with a
   uniform displacement, 64 px windows, 32 px overlap, 2-pass CWS; checks
   the recovered displacement, the valid share and the kernel launch
   counts, and prints pairs/s;
5. the engine's time per batch and its device time by kernel;
6. the CUDA engine against the CPU engine (plain versions) on one full-size
   pair.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits with 1 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
DISPLACEMENT = (3.3, -2.1)  # px, +x right, +y down
FRAME = (2048, 2048)
N_PAIRS = 8
BATCH = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (after warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment() -> str:
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is still on")
    return smi


def phase_build() -> None:
    from torchpiv_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {_build.sources()} in {time.perf_counter() - t0:.2f} s")


def shift_grid(ops, w: int) -> torch.Tensor:
    """``grid_sample`` coordinates of every window pixel (align_corners)."""
    B, Hp, Wp = ops.frame.shape
    dev = ops.frame.device
    n = torch.arange(ops.n_rows * ops.n_cols, device=dev)
    row0 = (n // ops.n_cols) * ops.step + ops.off
    col0 = (n % ops.n_cols) * ops.step + ops.off
    ar = torch.arange(w, device=dev, dtype=torch.float32)
    ys = (row0 + ops.dy).float()[..., None] + ops.fy[..., None] + ar  # [B, N, w]
    xs = (col0 + ops.dx).float()[..., None] + ops.fx[..., None] + ar
    gy = (2.0 * ys / (Hp - 1) - 1.0)[..., :, None].expand(-1, -1, w, w)
    gx = (2.0 * xs / (Wp - 1) - 1.0)[..., None, :].expand(-1, -1, w, w)
    return torch.stack([gx, gy], dim=-1).reshape(B, -1, w, 2)


def phase_kernels() -> dict:
    """``shift_windows`` against its plain version at the pass-2 shape."""
    from torchpiv_tpu_torch.kernels.shift import launch, shift_windows
    from torchpiv_tpu_torch.ops.shifts import blend_reference, shift_operands

    H, W = FRAME
    w, o = 32, 16
    n = ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    frames = torch.randint(0, 256, (BATCH, H, W), generator=g).float().to(dev)
    cases = {
        # fractional shifts, some beyond the +-S = 16 px clamp
        "fractional": (torch.rand(BATCH, n, generator=g) * 48 - 24,
                       torch.rand(BATCH, n, generator=g) * 48 - 24),
        # integer shifts (DWS and the floor-corner rule), some beyond +-S
        "integer": ((torch.rand(BATCH, n, generator=g) * 48 - 24).round(),
                    (torch.rand(BATCH, n, generator=g) * 48 - 24).round()),
        # integer in one axis only: the floor corner
        "mixed": ((torch.rand(BATCH, n, generator=g) * 20 - 10).round(),
                  torch.rand(BATCH, n, generator=g) * 20 - 10),
    }
    kw = dict(frame_shape=FRAME, wind_size=w, overlap=o)
    max_err = 0.0
    for name, (vx, vy) in cases.items():
        vx, vy = vx.to(dev), vy.to(dev)
        got = shift_windows(frames, vx, vy, **kw)
        ops = shift_operands(frames, vx, vy, **kw)
        want = blend_reference(ops, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        log(f"shift_windows {name}: max |kernel - plain| = {err!r}")
        if name == "fractional":
            # explicitly rounded blend in the plain version's order: equal
            # to the last bit is expected, 1e-4 of a grey level allowed
            check(err <= 1e-4, f"fractional shifts disagree by {err}")
        else:
            check(torch.equal(got, want), "integer shifts must be bit-exact")

    vx, vy = (t.to(dev) for t in cases["fractional"])
    ops = shift_operands(frames, vx, vy, **kw)
    grid = shift_grid(ops, w)
    img = ops.frame[:, None]
    ms = cuda_ms(lambda: launch(ops, w))
    wrapper_ms = cuda_ms(lambda: shift_windows(frames, vx, vy, **kw))
    plain_ms = cuda_ms(lambda: blend_reference(ops, w), reps=5)
    library_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode="border", align_corners=True))
    B, Hp, Wp = ops.frame.shape
    n_bytes = B * (Hp * Wp * 4 + n * 4 * 4 + n * w * w * 4)
    n_flops = B * n * w * w * 7
    bound_ms = max(n_bytes / H100_BYTES_PER_S, n_flops / H100_F32_FLOPS) * 1e3
    bound_by = ("bytes" if n_bytes / H100_BYTES_PER_S >= n_flops / H100_F32_FLOPS
                else "operations")
    row = {
        "name": "shift_windows", "route": "cuda",
        "source": "torchpiv_tpu_torch/kernels/csrc/shift_windows.cu",
        "replaces": "torchpiv_tpu/kernels/shift_pallas.py:44",
        "launches": None, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }
    log(json.dumps({"phase": "shift_windows", "shape": [B, Hp, Wp, n, w],
                    "kernel_ms": ms, "wrapper_ms": wrapper_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "library_ms": library_ms, "bytes": n_bytes,
                    "flops": n_flops}))
    log("kernels of the port: shift_windows")
    return row


def write_pairs(folder: str) -> None:
    from torchpiv_tpu_torch.io.decode import imwrite_gray
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    for i in range(N_PAIRS):
        fa, fb = particle_pair(FRAME, DISPLACEMENT, seed=100 + i)
        imwrite_gray(os.path.join(folder, f"p{i}_a.bmp"), fa)
        imwrite_gray(os.path.join(folder, f"p{i}_b.bmp"), fb)


def phase_main_path(folder: str, kernels):
    """OfflinePIV at 4 MP, w64/o32, 2-pass CWS; returns the launch counts
    and pairs/s."""
    from torchpiv_tpu_torch import OfflinePIV
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    piv = OfflinePIV(folder, wind_size=64, overlap=32, multipass=2,
                     multipass_mode="CWS", batch_size=BATCH)
    # warm-up (cuFFT plans, the caching allocator) through the engine on
    # the first batch, which also gives the valid share
    _, a, b = PIVDataset(folder, ".bmp").read_batch(list(range(BATCH)))
    _, _, inval = piv.engine(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())
    valid = 1.0 - inval.float().mean().item()
    log(f"engine: valid share {valid:.4f} over the first {BATCH} pairs")
    check(valid > 0.95, f"valid share {valid}")

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    fields = list(piv())
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    log(f"main path: {len(fields)} pairs in {elapsed:.3f} s = "
        f"{len(fields) / elapsed:.3f} pairs/s, launches {launches}")
    check(len(fields) == N_PAIRS, f"{len(fields)} of {N_PAIRS} pairs came out")
    check(launches["shift_windows"] == 2 * -(-N_PAIRS // BATCH), f"launches {launches}")

    unit = 1000.0  # px -> output units: scale / dt * 1000, defaults 1 and 1
    shape = piv.engine.final_field_shape
    for x, y, u, v in fields:
        check(u.shape == v.shape == shape, f"field shape {u.shape}")
        check(np.isfinite(u).all() and np.isfinite(v).all(), "non-finite field")
        mu = u[2:-2, 2:-2].mean() / unit
        mv = -v[2:-2, 2:-2].mean() / unit  # the y axis is flipped
        check(abs(mu - DISPLACEMENT[0]) < 0.05, f"mean u {mu}")
        check(abs(mv - DISPLACEMENT[1]) < 0.05, f"mean v {mv}")
    log(f"main path: interior mean displacement of the last pair "
        f"({mu:.4f}, {mv:.4f}) px, expected {DISPLACEMENT}")
    return launches, len(fields) / elapsed


def phase_profile(folder: str) -> float:
    """Engine time per batch (CUDA events) and device time by kernel
    (``torch.profiler``) for one main-path batch; returns ms per pair."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchpiv_tpu_torch import MultipassPIV, PIVConfig
    from torchpiv_tpu_torch.io.dataset import PIVDataset
    from torchpiv_tpu_torch.pipeline import packed_forward

    _, a, b = PIVDataset(folder, ".bmp").read_batch(list(range(BATCH)))
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    engine = MultipassPIV(PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32,
                                    multipass=2))
    ms = cuda_ms(lambda: packed_forward(engine, a, b), reps=5)
    log(f"engine: {ms:.3f} ms per batch of {BATCH} = {ms / BATCH:.3f} ms/pair "
        f"(device-resident uint8 frames, host tail excluded)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        packed_forward(engine, a, b)
        torch.cuda.synchronize()
    # device-side events only (kernels, memcpy): an operator's row repeats
    # the time of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    log(f"profile: {total / 1e3:.3f} ms of device time in one batch")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"profile: {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return ms / BATCH


def phase_reference(folder: str) -> None:
    """The CUDA engine against the CPU engine on one full-size pair."""
    from torchpiv_tpu_torch import MultipassPIV, PIVConfig
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    fa, fb = PIVDataset(folder, ".bmp")[0]
    cfg = PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32, multipass=2)
    t0 = time.perf_counter()
    cu, cv, ci = (t.cpu().numpy() for t in MultipassPIV(cfg, device="cuda")(
        torch.from_numpy(fa), torch.from_numpy(fb)))
    pu, pv, pi = (t.numpy() for t in MultipassPIV(cfg, device="cpu")(
        torch.from_numpy(fa), torch.from_numpy(fb)))
    both = ~(ci | pi)
    flips = float((ci != pi).mean())
    rms = float(np.sqrt(np.mean(np.concatenate([(cu - pu)[both], (cv - pv)[both]]) ** 2)))
    log(f"reference: CUDA vs CPU engine: mask mismatch {flips:.5f}, "
        f"RMS {rms:.3e} px on jointly valid vectors "
        f"({time.perf_counter() - t0:.1f} s)")
    check(flips < 0.02 and rms < 0.01, f"mask mismatch {flips}, RMS {rms}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torchpiv_tpu_torch.kernels import KERNELS

    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    row = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as folder:
        t0 = time.perf_counter()
        write_pairs(folder)
        log(f"wrote {N_PAIRS} pairs of {FRAME} in {time.perf_counter() - t0:.1f} s")
        launches, pairs_per_s = phase_main_path(folder, KERNELS)
        engine_ms = phase_profile(folder)
        log(f"main path: engine busy share {engine_ms * pairs_per_s / 1e3:.3f} "
            f"(engine ms/pair x pairs/s; the rest is host work the card waits on)")
        phase_reference(folder)
    row["launches"] = launches["shift_windows"]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
