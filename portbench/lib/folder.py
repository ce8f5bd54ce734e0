"""The closed loop over a folder of 8-bit BMP pairs (``drive: folder``):
the program's ``OfflinePIV`` as users run it.

At set-up the mix's unique pairs are written once under ``TMPDIR`` and
hard-linked, in a seeded order, to as many pair names as the window could
take at ``LINK_MARGIN`` times the engine's own pace, timed at set-up on a
warm dispatch of the cell's batch (the folder cannot yield faster than
the engine): links cost no bytes, so decode reads the page cache, not the
disk.  Writing the folder is the harness's own work, and it grows with
the engine's pace: the run reports it as ``harness_s``, which ``setup_s``
leaves out.  Timing the engine stays in ``setup_s``: it builds and warms
the program's kernels as a user's first engine would.  The generator's
first fields (its small first batch and two full ones) are set-up; the
window opens after them and closes ``seconds`` later, and the generator
is closed there.  A generator that runs out of names before the close
raises: the rate would otherwise stop at the folder's size.
"""
from __future__ import annotations

import os
import random
import shutil
import struct
import sys
import tempfile
import time

import numpy as np
import torch

from .sample import Reservoir

WARM_BATCHES = 2  # full batches taken before the window opens
# names for this many times the engine's timed pace: the folder cannot
# yield faster than the engine alone, and a link costs about 0.15 ms
LINK_MARGIN = 1.5
LINK_SLACK_S = 5  # seconds of names beyond the window, for the warm-up
DRY = object()
DRIVE = True


def bmp_bytes(img: np.ndarray) -> bytes:
    """An uncompressed bottom-up 8-bit BMP with a grey palette."""
    h, w = img.shape
    stride = (w + 3) & ~3
    offset = 14 + 40 + 1024
    head = b"BM" + struct.pack("<IHHI", offset + stride * h, 0, 0, offset)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, stride * h, 0, 0, 256, 0)
    palette = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    palette[:, 3] = 0
    rows = np.zeros((h, stride), dtype=np.uint8)
    rows[:, :w] = img[::-1]
    return head + dib + palette.tobytes() + rows.tobytes()


def write_folder(frames_a: np.ndarray, frames_b: np.ndarray, n_links: int,
                 seed: int) -> tuple:
    """The folder and, for each pair name in sorted order, the unique pair
    it links to."""
    root = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    src = os.path.join(root, "unique")
    os.mkdir(src)
    n = len(frames_a)
    for k in range(n):
        for tag, f in (("a", frames_a[k]), ("b", frames_b[k])):
            with open(os.path.join(src, f"{k}_{tag}.bmp"), "wb") as fh:
                fh.write(bmp_bytes(f))
    order = list(range(n))
    random.Random(seed).shuffle(order)
    which = [order[i % n] for i in range(n_links)]
    for i, k in enumerate(which):
        for tag in ("a", "b"):
            os.link(os.path.join(src, f"{k}_{tag}.bmp"),
                    os.path.join(root, f"{i:07d}_{tag}.bmp"))
    return root, which


def engine_pace(cell, device) -> float:
    """Pairs a second of the engine alone at the cell's batch: a fresh
    engine, warmed, then three dispatches timed to the card's end."""
    from torchpiv_tpu_torch.pipeline import packed_forward

    from .staged import warm_engine

    engine, _ = warm_engine(cell, device)
    fa, fb = cell.frames
    B = cell.config["batch"]
    t = time.perf_counter()
    with torch.no_grad():
        for _ in range(3):
            packed_forward(engine, fa[:B], fb[:B])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return 3 * B / (time.perf_counter() - t)


def setup(cell, device, seconds: float, seed: int):
    """Write the folder and build ``OfflinePIV`` over it (its constructor
    decodes the first pair and builds the engine)."""
    from torchpiv_tpu_torch.pipeline import OfflinePIV

    cfg = cell.config
    fa, fb = cell.frames
    t = time.perf_counter()
    pace = engine_pace(cell, device)
    n_links = int(LINK_MARGIN * pace * (seconds + LINK_SLACK_S)) + len(fa)
    print(f"engine alone {pace:.1f} pairs/s (timed in {time.perf_counter() - t:.2f} s): "
          f"{n_links} pair names", file=sys.stderr, flush=True)
    t = time.perf_counter()
    root, which = write_folder(fa.cpu().numpy(), fb.cpu().numpy(), n_links, seed)
    harness_s = time.perf_counter() - t
    print(f"{n_links} pair names written in {harness_s:.2f} s",
          file=sys.stderr, flush=True)
    eng = dict(cfg["engine"])
    kw = {k: eng.pop(k) for k in ("wind_size", "overlap", "multipass",
                                  "multipass_mode", "multipass_scale") if k in eng}
    piv = OfflinePIV(root, device=str(device), batch_size=cfg["batch"],
                     folder_mode="pairs", engine_options=eng, **kw)
    return {"piv": piv, "root": root, "which": which, "gen": None,
            "harness_s": harness_s}


def window(cell, state, seconds: float, seed: int, traced: bool,
           on_open=None, on_close=None):
    """Start the generator, take its first fields (set-up), then take
    fields for ``seconds``; returns the run's records."""
    piv = state["piv"]
    if traced:
        piv.span_log = []
    gen = piv()
    state["gen"] = gen
    B = cell.config["batch"]
    warm = min(4, B) + WARM_BATCHES * B
    got = 0
    for _ in range(warm):
        if next(gen, DRY) is DRY:
            raise RuntimeError(f"the folder's {len(state['which'])} pair names ran out "
                               "in the warm-up")
        got += 1
    if traced:
        del piv.span_log[:]
    sample = Reservoir(cell.check_pairs, random.Random(seed))
    t0 = time.perf_counter()
    t_end = t0 + seconds
    if on_open is not None:
        on_open()
    fields = 0
    for field in gen:
        now = time.perf_counter()
        if now > t_end:
            break
        pid = state["which"][got]
        sample.offer(lambda: {"pair": pid, "field": field, "invalid": None})
        got += 1
        fields += 1
    else:
        raise RuntimeError(f"the folder's {len(state['which'])} pair names ran out "
                           f"{t_end - time.perf_counter():.2f} s before the window's close")
    if on_close is not None:
        on_close()
    spans = list(piv.span_log or [])
    gen.close()
    return {"t0": t0, "fields": fields, "seconds": seconds,
            "attempted": fields, "failed": 0, "harness_s": state["harness_s"],
            "span_log": spans, "samples": sample.items}


def teardown(state) -> None:
    gen = state.get("gen")
    if gen is not None:
        gen.close()
    state.pop("piv", None)
    shutil.rmtree(state["root"], ignore_errors=True)
