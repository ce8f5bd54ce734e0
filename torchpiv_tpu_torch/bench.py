"""The ``bench`` protocol of the root ``bench.py`` on the port's engine:
4 MP image-pair throughput, 64 px windows, 50% overlap, 2-pass CWS — the
reference's published configuration (TorchPIV README: 4,000 such pairs in
<10 min on a GTX 1660 Ti ≈ 6.7 pairs/s).

    python -m torchpiv_tpu_torch.bench        # or: tpiv-torch bench

Prints ONE JSON line on standard output, with ``bench.py``'s keys and the
card it ran on:
  {"metric": "4MP_pairs_per_sec", "value": N, "unit": "pairs/s",
   "vs_baseline": N/6.7, "scan_batch": B, "coldstart_s": S, ...,
   "device": {"kind": ..., "power_limit": ...}}

Protocol: ``BENCH_UNIQUE`` synthetic 2048x2048 particle pairs, staged on
the device as batches of ``BENCH_BATCH`` that cycle through them; each of
``BENCH_REPEATS`` reps dispatches every staged batch back to back
(``BENCH_PAIRS`` pairs), then copies each packed result to the host and
runs the per-pair host tail (validation NaN/infill, flip, units) as it
lands; the value is the median rep.  The first batch, which builds the
kernels where they are not built yet, is timed apart as ``coldstart_s``
and excluded.  With ``BENCH_PIPELINE`` (default on) ``OfflinePIV`` runs
end to end over ``BENCH_PIPELINE_PAIRS`` BMP files of the same pairs, as
in ``bench.py``.

The root script's TPU-only parts have no counterpart: the subprocess probe
of a network-attached backend, the repository-resident ``.jaxcache`` (the
port's build cache is ``utils.compile_cache``) and the tunnel notes.  This
is no benchmark harness: it writes no ``BENCHMARK.json``.  It runs on the
CUDA card and fails without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_PAIRS_PER_SEC = 6.7  # reference README: 4000 pairs / <10 min
FRAME = (2048, 2048)  # 4 MP
DISPLACEMENT = (3.3, -2.1)
# The root bench.py batches 64 pairs, because the TPU engine runs a
# lax.scan over the batch and pays a dispatch per call.  The port batches
# as tensors, so its peak memory grows with the batch: the unfused CWS
# engine peaked at 2833.4 MiB (max_memory_allocated) at a batch of 4
# (chip_smoke.py phase 7; NVIDIA H100 80GB HBM3, 700.00 W), about 0.7 GB
# a pair, so 64 pairs would need about 45 GB on top of 512 MB of staged
# frames.  8 pairs need about 5.7 GB, and the engine's launches are
# already amortised over 4.
BATCH = 8
UNIQUE_PAIRS = 4
BENCH_PAIRS = 256
REPEATS = 5


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card() -> dict:
    """The card's name and power limit (``nvidia-smi``)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return {"kind": torch.cuda.get_device_name(0),
            "power_limit": out.splitlines()[0].split(",")[-1].strip()}


def main() -> int:
    import torch

    from .config import PIVConfig
    from .models.multipass import MultipassPIV
    from .pipeline import finalize_fields, packed_forward
    from .utils.device import resolve_device
    from .utils.synthetic import particle_pair

    batch = int(os.environ.get("BENCH_BATCH", BATCH))
    unique = int(os.environ.get("BENCH_UNIQUE", UNIQUE_PAIRS))
    n_pairs = int(os.environ.get("BENCH_PAIRS", BENCH_PAIRS))
    repeats = int(os.environ.get("BENCH_REPEATS", REPEATS))
    device = resolve_device("auto")  # the card; raises without one
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_info = card()
    log(f"device: {device} {dev_info}")
    cfg = PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32, multipass=2,
                    multipass_mode="CWS")
    engine = MultipassPIV(cfg, device=device)

    log(f"generating {unique} unique 4 MP synthetic pairs...")
    t0 = time.perf_counter()
    pairs = [particle_pair(FRAME, displacement=DISPLACEMENT, density=0.01,
                           seed=i) for i in range(unique)]
    n_batches = -(-n_pairs // batch)
    host_batches = []
    for b in range(n_batches):
        idx = [(b * batch + i) % unique for i in range(batch)]
        host_batches.append((np.stack([pairs[i][0] for i in idx]),
                             np.stack([pairs[i][1] for i in idx])))
    log(f"data generation: {time.perf_counter() - t0:.1f} s")
    x, y = engine.final_coordinates

    def tail(packed):
        return finalize_fields(packed[0], packed[1], packed[2] > 0.5,
                               x, y, 1.0, 1.0)

    # the first batch: kernel builds (where not built yet), cuFFT plans,
    # the caching allocator, the D2H and the host tail
    t0 = time.perf_counter()
    a, b = (torch.from_numpy(f).to(device) for f in host_batches[0])
    tail(packed_forward(engine, a, b).cpu().numpy()[0])
    coldstart_s = time.perf_counter() - t0
    log(f"build+first batch: {coldstart_s:.1f} s")

    t0 = time.perf_counter()
    dev_batches = [tuple(torch.from_numpy(f).to(device) for f in hb)
                   for hb in host_batches]
    torch.cuda.synchronize(device)
    h2d_s = time.perf_counter() - t0
    mb = n_batches * 2 * batch * FRAME[0] * FRAME[1] / 2**20
    log(f"H2D staging: {mb:.0f} MB in {h2d_s:.2f} s ({mb / h2d_s:.0f} MB/s, "
        f"pageable)")

    rates = []
    with torch.no_grad():
        for rep in range(repeats):
            t0 = time.perf_counter()
            done = 0
            results = None
            pending = [packed_forward(engine, a, b_) for a, b_ in dev_batches]
            for out in pending:
                arr = out.cpu().numpy()
                for i in range(arr.shape[0]):
                    results = tail(arr[i])
                    done += 1
            wall = time.perf_counter() - t0
            if results is None:
                raise RuntimeError("the host tail skipped every pair")
            rates.append(done / wall)
            log(f"rep {rep + 1}/{repeats}: {done} pairs in {wall:.2f} s -> "
                f"{done / wall:.1f} pairs/s ({1000 * wall / done:.1f} ms/pair)")
    pairs_per_sec = float(np.median(rates))
    log(f"median of {repeats}: {pairs_per_sec:.1f} pairs/s "
        f"(spread {min(rates):.1f}-{max(rates):.1f})")

    out = {
        "metric": "4MP_pairs_per_sec",
        "value": round(pairs_per_sec, 2),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 2),
        "scan_batch": batch,
        "coldstart_s": round(coldstart_s, 1),
    }
    del dev_batches, pending
    if os.environ.get("BENCH_PIPELINE", "1") != "0":
        p = bench_pipeline(pairs, batch, device, pairs_per_sec)
        out["pipeline_pairs_per_sec"] = round(p["rate"], 2)
        out["pipeline_h2d_bound_pairs_per_sec"] = round(p["bound"], 2)
        out["pipeline_vs_bound"] = round(p["rate"] / p["bound"], 2)
        out["time_to_first_field_s"] = round(p["time_to_first_field_s"], 2)
        frame_mb = FRAME[0] * FRAME[1] / 2**20
        h2d = p["h2d_mb_s"]
        out["bound_table"] = {
            "decode_gb_per_sec": round(p["decode_gb_s"], 2),
            "ingest_pairs_per_sec_local": round(p["ingest_pairs_per_sec"], 1),
            "h2d_mb_per_sec_in_run": round(h2d, 1) if np.isfinite(h2d) else None,
            "h2d_mb_per_sec_needed_for_67_pairs": round(67 * 2 * frame_mb, 0),
            "engine_pairs_per_sec": round(pairs_per_sec, 2),
            "target_pairs_per_sec": 66.7,
        }
        log(f"pipeline bound check: {p['rate']:.2f} pairs/s achieved vs "
            f"{p['bound']:.2f} pairs/s in-run bound "
            f"({100 * p['rate'] / p['bound']:.0f}%)")
    out["device"] = dev_info
    print(json.dumps(out))
    return 0


def bench_pipeline(pairs, batch: int, device, engine_pairs_per_sec: float) -> dict:
    """``OfflinePIV`` end to end over BMP files of ``pairs`` (native
    decode, prefetch and H2D, engine, overlapped host tail), the loop a
    user runs: time to the first field on a fresh pipeline, then the
    steady rate of a second pass against ``min(in-run H2D rate, engine
    rate)``; also the native decoder's rate and the ingest machinery's
    without a device."""
    import glob
    import tempfile

    import torch

    from .io.dataset import PIVDataset
    from .io.decode import imwrite_gray
    from .io.prefetch import PairPrefetcher
    from .native import loader as fastio
    from .pipeline import OfflinePIV

    n_pairs = int(os.environ.get("BENCH_PIPELINE_PAIRS", 4 + 2 * batch))
    with tempfile.TemporaryDirectory(prefix="tpiv_bench_pairs_") as folder:
        t0 = time.perf_counter()
        for i in range(n_pairs):
            fa, fb = pairs[i % len(pairs)]
            imwrite_gray(os.path.join(folder, f"p{i:04d}_a.bmp"), fa)
            imwrite_gray(os.path.join(folder, f"p{i:04d}_b.bmp"), fb)
        log(f"pipeline dataset: {n_pairs} 4 MP pairs written in "
            f"{time.perf_counter() - t0:.1f} s")

        files = sorted(glob.glob(os.path.join(folder, "*.bmp")))
        decode_gb_s = 0.0
        if fastio.available():
            dims = fastio.probe_gray(files[0])
            fastio.read_batch_gray(files, dims, threads=8)  # warm page cache
            t0 = time.perf_counter()
            frames, status = fastio.read_batch_gray(files, dims, threads=8)
            dt = time.perf_counter() - t0
            mb = frames.nbytes / 2**20
            decode_gb_s = mb / dt / 1024
            log(f"native decode (warm cache): {len(files)} files, {mb:.0f} MB "
                f"in {dt:.2f} s = {decode_gb_s:.2f} GB/s "
                f"(errors: {(status != 0).sum()})")

        ds = PIVDataset(folder, ".bmp", "pairs")

        def drain():
            t0 = time.perf_counter()
            got = sum(len(ids) for _, _, ids in PairPrefetcher(
                ds, batch_size=batch, device=torch.device("cpu"),
                num_threads=8))
            return got, time.perf_counter() - t0

        drain()  # warm the page cache and the pool
        got, dt_ing = drain()
        ingest_rate = got / dt_ing
        log(f"ingest machinery (disk->decode->batch, no device): {got} pairs "
            f"in {dt_ing:.2f} s = {ingest_rate:.0f} pairs/s")

        piv = OfflinePIV(folder, device=str(device), file_fmt=".bmp",
                         wind_size=64, overlap=32,
                         multipass=2, multipass_mode="CWS", batch_size=batch)
        t0 = time.perf_counter()
        ttff = None
        for _ in piv():
            if ttff is None:
                ttff = time.perf_counter() - t0
        if ttff is None:
            raise RuntimeError("pipeline produced no fields")
        log(f"time to first field (fresh pipeline, kernels built): {ttff:.2f} s")

        piv.transfer_log = tlog = []
        t0 = time.perf_counter()
        done = sum(1 for _ in piv())
        wall = time.perf_counter() - t0
    rate = done / wall
    frame_mb = FRAME[0] * FRAME[1] / 2**20
    total_mb = sum(nb for _, _, nb in tlog) / 2**20
    busy = sum(e - s for s, e in _merge_intervals([(s, e) for s, e, _ in tlog]))
    if busy > 0:
        h2d_mb_s = total_mb / busy
        h2d_rate = h2d_mb_s / (2 * frame_mb)  # pairs/s if H2D-bound
        log(f"in-run H2D: {total_mb:.0f} MB in {busy:.2f} s busy "
            f"({h2d_mb_s:.0f} MB/s) over {len(tlog)} batch transfers")
    else:
        h2d_mb_s = h2d_rate = float("inf")
    bound = min(h2d_rate, engine_pairs_per_sec)
    log(f"pipeline: {done} pairs end-to-end in {wall:.2f} s = {rate:.1f} "
        f"pairs/s; bound components: H2D {h2d_rate:.1f} / engine "
        f"{engine_pairs_per_sec:.1f} pairs/s")
    return {"rate": rate, "bound": bound, "h2d_mb_s": h2d_mb_s,
            "decode_gb_s": decode_gb_s, "ingest_pairs_per_sec": ingest_rate,
            "time_to_first_field_s": ttff}


def _merge_intervals(spans):
    """Union of (start, end) intervals, as a list of disjoint spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


if __name__ == "__main__":
    sys.exit(main())
