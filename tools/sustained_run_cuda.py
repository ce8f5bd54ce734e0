#!/usr/bin/env python3
"""One sustained 4,000-pair run at the headline configuration on the
port's engine: the reference's published job (TorchPIV README: 4,000 x 4
MP pairs, 64 px windows, 50% overlap, 2 iterations) in one uninterrupted
wall-clock measurement on one CUDA card.  The counterpart of
``tools/sustained_run.py``.

    python tools/sustained_run_cuda.py [--device cpu] [--use-pallas off]

A small set of device-resident input batches cycles through the engine
(``pipeline.packed_forward``) until ``SUSTAINED_PAIRS`` pairs have
completed, the per-pair host tail (``pipeline.tail_of``: validation NaN,
infill, flip, units) included, and the single total is reported.
Ingest is excluded, as in the JAX tool.

* ``SUSTAINED_UNIQUE`` unique pairs ``particle_pair(FRAME, (3.3, -2.1),
  density=0.01, seed=i)`` are staged as ``SUSTAINED_STAGED`` batches of
  ``SUSTAINED_BATCH``; batch ``b`` holds the unique pairs ``(b + j) %
  n_unique``, so the card sees distinct inputs batch to batch.
* The build of the kernels (where they are not built yet) and the first
  batch, its host tail included, are excluded and reported.
* Each dispatch's packed ``[B, 3, R, C]`` result is copied
  ``non_blocking`` into a pinned host buffer and a CUDA event is recorded
  behind the copy; once ``SUSTAINED_INFLIGHT`` results are queued, the
  oldest one's event is waited on and its pairs go through the host tail.
* The JAX tool counts ``ceil(N / BATCH)`` full dispatches, so its "4000"
  at a batch of 64 is 4,032 pairs.  Here the last dispatch is cut to the
  pairs still owed: exactly ``SUSTAINED_PAIRS`` pairs are finalized and
  ``n_pairs`` counts them.  The default batch (8, the port's
  ``bench.BATCH``) divides 4,000.

Prints the card's name and power limit first, then one JSON line:
  {"metric": "sustained_4000_pairs_s", "value": total_s, "unit": "s",
   "pairs_per_sec": N, "n_pairs": N, ...}
Progress goes to standard error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME = (2048, 2048)
DISPLACEMENT = (3.3, -2.1)
N_PAIRS = 4000
BATCH = 8  # torchpiv_tpu_torch/bench.py: about 0.7 GB of device memory a pair
STAGED = 6
INFLIGHT = 8
UNIQUE = 8
CHECKPOINT_EVERY = 800


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def settings() -> dict:
    """The run's sizes from the ``SUSTAINED_*`` variables."""
    env = os.environ.get
    return {"n_pairs": int(env("SUSTAINED_PAIRS", N_PAIRS)),
            "batch": int(env("SUSTAINED_BATCH", BATCH)),
            "staged": int(env("SUSTAINED_STAGED", STAGED)),
            "inflight": int(env("SUSTAINED_INFLIGHT", INFLIGHT)),
            "n_unique": int(env("SUSTAINED_UNIQUE", UNIQUE))}


def unique_pairs(frame, n_unique: int) -> list:
    """The run's unique pairs, made in threads."""
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    def one(i):
        return particle_pair(frame, displacement=DISPLACEMENT, density=0.01, seed=i)

    with ThreadPoolExecutor(min(4, n_unique)) as pool:
        return list(pool.map(one, range(n_unique)))


def staged_index(dispatch: int, j: int, staged: int, n_unique: int) -> int:
    """The unique pair at position ``j`` of dispatch ``dispatch``."""
    return (dispatch % staged + j) % n_unique


def run(device, frame=FRAME, n_pairs=N_PAIRS, batch=BATCH, staged=STAGED,
        inflight=INFLIGHT, n_unique=UNIQUE, engine_options=None, pairs=None,
        on_field=None) -> dict:
    """The sustained run on ``device``; returns the JSON line's numbers
    and ``compile_first_batch_s``, ``checkpoints`` (pairs done -> seconds)
    and ``engine`` (the engine it ran).  ``pairs`` replaces the generated
    unique pairs; ``on_field(k, unique_index, field)`` sees every
    finalized pair in order (``field`` is ``(x, y, u, v)`` or None where
    the tail skips the pair) and runs inside the timed loop."""
    from torchpiv_tpu_torch.config import PIVConfig
    from torchpiv_tpu_torch.models.multipass import MultipassPIV
    from torchpiv_tpu_torch.pipeline import packed_forward, tail_of

    cuda = device.type == "cuda"
    cfg = PIVConfig(frame_shape=tuple(frame), wind_size=64, overlap=32, multipass=2,
                    multipass_mode="CWS", **(engine_options or {}))
    engine = MultipassPIV(cfg, device=device)
    tail = tail_of(engine, 1.0, 1.0)

    if pairs is None:
        log(f"generating {n_unique} unique pairs of {tuple(frame)}...")
        t0 = time.perf_counter()
        pairs = unique_pairs(frame, n_unique)
        log(f"generated in {time.perf_counter() - t0:.1f} s")
    n_unique = len(pairs)
    t0 = time.perf_counter()
    dev_batches = []
    for b in range(staged):
        idx = [staged_index(b, j, staged, n_unique) for j in range(batch)]
        dev_batches.append(tuple(
            torch.from_numpy(np.stack([pairs[i][k] for i in idx])).to(device)
            for k in (0, 1)))
    if cuda:
        torch.cuda.synchronize(device)
    log(f"staged {staged} batches of {batch} in {time.perf_counter() - t0:.1f} s")

    R, C = engine.final_field_shape
    # one buffer more than the queue holds: a dispatch is issued before the
    # oldest one is drained
    host = ([torch.empty((batch, 3, R, C), dtype=torch.float32, pin_memory=True)
             for _ in range(inflight + 1)] if cuda else None)

    def issue(i: int, n: int):
        a, b = dev_batches[i % staged]
        packed = packed_forward(engine, a[:n], b[:n])
        if not cuda:
            return i, packed.numpy(), None
        buf = host[i % (inflight + 1)][:n]
        buf.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return i, buf, done

    done = 0
    checkpoints = {}

    def drain(item, t_start):
        nonlocal done
        i, buf, copied = item
        if copied is not None:
            copied.synchronize()
            buf = buf.numpy()
        for j in range(buf.shape[0]):
            field = tail(buf[j, 0], buf[j, 1], buf[j, 2] > 0.5)
            if on_field is not None:
                on_field(done, staged_index(i, j, staged, n_unique), field)
            done += 1
            if t_start is not None and done % CHECKPOINT_EVERY == 0:
                checkpoints[done] = el = time.perf_counter() - t_start
                log(f"  {done} pairs at {el:.1f} s ({done / el:.1f} pairs/s)")

    with torch.no_grad():
        # kernel builds (where not built yet), cuFFT plans, the caching
        # allocator, the D2H and the host tail (excluded, reported)
        t0 = time.perf_counter()
        _, first, copied = issue(0, batch)
        if copied is not None:
            copied.synchronize()
            first = first.numpy()
        tail(first[0, 0], first[0, 1], first[0, 2] > 0.5)
        first_s = time.perf_counter() - t0
        log(f"build+first batch: {first_s:.1f} s")

        n_dispatches = -(-n_pairs // batch)
        log(f"sustained run: {n_dispatches} dispatches of up to {batch} pairs...")
        pending = deque()
        t0 = time.perf_counter()
        for i in range(n_dispatches):
            pending.append(issue(i, min(batch, n_pairs - i * batch)))
            if len(pending) >= inflight:
                drain(pending.popleft(), t0)
        while pending:
            drain(pending.popleft(), t0)
        total = time.perf_counter() - t0
    log(f"TOTAL: {done} pairs in {total:.1f} s = {done / total:.1f} pairs/s "
        f"({1000 * total / done:.2f} ms/pair)")
    return {"metric": f"sustained_{n_pairs}_pairs_s", "value": total, "unit": "s",
            "pairs_per_sec": done / total, "n_pairs": done,
            "compile_first_batch_s": first_s, "checkpoints": checkpoints,
            "engine": engine}


def main(argv=None) -> int:
    from torchpiv_tpu_torch.utils.device import script_device
    from torchpiv_tpu_torch.utils.scripts import add_device_args

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args = add_device_args(ap).parse_args(argv)
    device, card = script_device(args.device)
    print(card, flush=True)
    s = settings()
    log(f"device {device}: {s}")
    out = run(device, frame=FRAME, engine_options={"use_pallas": args.use_pallas}, **s)
    print(json.dumps({
        "metric": out["metric"], "value": round(out["value"], 3), "unit": "s",
        "pairs_per_sec": round(out["pairs_per_sec"], 2), "n_pairs": out["n_pairs"],
        "batch": s["batch"], "compile_first_batch_s": round(out["compile_first_batch_s"], 2),
        "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
