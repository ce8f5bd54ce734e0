#!/usr/bin/env python3
"""Fresh-process time to first field of the port's ``OfflinePIV`` on one
CUDA card: the counterpart of ``tools/coldstart.py``.

    python tools/coldstart_cuda.py [--device cpu] [--folder DIR]
    TORCHPIV_CACHE_DIR=$(mktemp -d) python tools/coldstart_cuda.py   # cold

Measures what a user sees between starting a run and the first velocity
field landing, in parts that follow one another (``parts``):

* ``imports_s``: ``import torch`` (``import_torch_s``) and the port
  (``import_port_s``);
* ``card_init_s``: the CUDA context and the first allocation;
* ``decoder_load_s``: the native decoder (``native/loader.py``, built with
  ``g++`` where the build directory lacks it);
* ``engine_build_s``: ``OfflinePIV(...)`` (the JAX tool's key);
* ``first_batch_s``: from the generator's start to the first field (the
  JAX tool's key): decode, H2D, engine, D2H and the first host tail;
  ``first_batch_spans`` splits it with ``OfflinePIV.span_log``, whose
  ``tail_s`` is the first batch's host tail.

The kernels load as on a user's run: each one at its first launch, built
by ``nvcc`` where the build directory lacks it (``kernels/_build.py``), so
only the ones the engine launches.  ``kernel_load_s`` is their seconds,
spent inside ``engine_build_s`` and ``first_batch_s``, and
``kernel_loads`` names them with their seconds and whether each was built.
The build directory is that of ``utils/compile_cache.py``
(``TORCHPIV_CACHE_DIR``; an empty one makes this the cold number).

``time_to_first_field_s`` runs from this script's first line (the
interpreter's own start is not in it; a caller that times the process sees
it) to the first field.  The engine is w64/o32, 2-pass CWS, batch
``COLDSTART_BATCH`` (16), as in the JAX tool.  ``--folder`` names the
pairs; where it is missing or empty, ``COLDSTART_PAIRS`` (48) pairs of 4
MP BMP files are made there (4 generated pairs and hard links to them) by
a child process, so that nothing it imports is charged, and the making is
excluded.  A folder that holds anything is timed as it is and left as it
is.  The default folder is ``$TMPDIR/tpiv_coldstart_cuda_<N>pairs``.

Prints the card's name and power limit, then one JSON line:
  {"metric": "time_to_first_field_s", "value": N, "unit": "s",
   "first_batch_s": N, "engine_build_s": N, "n_pairs": N, "total_s": N,
   "parts": {...}, "kernel_load_s": N, ...}
"""
import time

T_PROC = time.perf_counter()  # before the heavy imports

import argparse  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
FRAME = (2048, 2048)
N_PAIRS = 48
BATCH = 16
N_UNIQUE = 4
DISPLACEMENT = (3.3, -2.1)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def default_folder(n_pairs: int) -> str:
    return os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"tpiv_coldstart_cuda_{n_pairs}pairs")


def make_dataset(folder: str, n_pairs: int, frame=FRAME) -> None:
    """``n_pairs`` BMP pairs in ``folder``, which must be missing or empty:
    ``N_UNIQUE`` generated ones, the rest hard links to them (pair ``i`` is
    pair ``i % N_UNIQUE``).  They are written into a sibling directory that
    is renamed onto ``folder`` at the end, so an interrupted run leaves no
    half-made folder."""
    import tempfile

    sys.path.insert(0, REPO)
    from torchpiv_tpu_torch.io.decode import imwrite_gray
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    folder = os.path.abspath(folder)
    if os.path.isdir(folder) and os.listdir(folder):
        raise FileExistsError(f"{folder} is not empty: the pairs are made only "
                              f"in a missing or empty folder")
    os.makedirs(os.path.dirname(folder), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(folder) + ".", suffix=".partial",
                           dir=os.path.dirname(folder))
    for i in range(n_pairs):
        for k, name in enumerate(("a", "b")):
            path = os.path.join(tmp, f"p{i:04d}_{name}.bmp")
            if i < N_UNIQUE:
                if k == 0:
                    pair = particle_pair(frame, displacement=DISPLACEMENT,
                                         density=0.01, seed=i)
                imwrite_gray(path, pair[k])
            else:
                os.link(os.path.join(tmp, f"p{i % N_UNIQUE:04d}_{name}.bmp"), path)
    os.rename(tmp, folder)  # onto a missing or an empty directory


def ensure_dataset(folder: str, n_pairs: int) -> float:
    """Make the pairs in a child process where ``folder`` is missing or
    empty; returns the seconds that took.  A folder that holds anything is
    left as it is."""
    if os.path.isdir(folder) and os.listdir(folder):
        log(f"timing {folder} as it is ({len(glob.glob(os.path.join(folder, '*')))} files)")
        return 0.0
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__), "--make-dataset",
                    "--folder", folder],
                   env={**os.environ, "COLDSTART_PAIRS": str(n_pairs)}, check=True)
    return time.perf_counter() - t0


def measure(device_name, folder: str, batch: int, use_pallas: str, t_start: float) -> dict:
    """Everything after the dataset, in order; returns the JSON line."""
    t0 = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    sys.path.insert(0, REPO)
    from torchpiv_tpu_torch.pipeline import OfflinePIV
    from torchpiv_tpu_torch.utils.device import script_device

    t_port = time.perf_counter()
    device, card = script_device(device_name)
    print(card, flush=True)
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    t_card = time.perf_counter()
    from torchpiv_tpu_torch.kernels import _build
    from torchpiv_tpu_torch.native import loader
    from torchpiv_tpu_torch.utils.compile_cache import build_dir

    decoder = loader.available()
    t_decoder = time.perf_counter()
    piv = OfflinePIV(folder, device=str(device), file_fmt=".bmp", wind_size=64,
                     overlap=32, multipass=2, multipass_mode="CWS", batch_size=batch,
                     engine_options={"use_pallas": use_pallas})
    t_engine = time.perf_counter()
    log(f"imports+card+decoder+engine build: {t_engine - t_start:.1f} s "
        f"(engine build alone {t_engine - t_decoder:.1f} s)")
    piv.span_log = spans = []
    gen = piv()
    first = next(gen)
    t_first = time.perf_counter()
    if first is None:
        raise RuntimeError("the first pair yielded no field")
    kernel_loads = _build.load_log()  # the loads the first field waited on
    n = 1 + sum(1 for _ in gen)
    t_all = time.perf_counter()
    parts = {"import_torch_s": t_torch - t0, "import_port_s": t_port - t_torch,
             "imports_s": t_port - t0, "card_init_s": t_card - t_port,
             "decoder_load_s": t_decoder - t_card, "engine_build_s": t_engine - t_decoder,
             "first_batch_s": t_first - t_engine}
    kernel_load_s = sum(k["s"] for k in kernel_loads.values())
    span = {k: v for k, v in spans[0].items() if k != "first_field_t"}
    ttff = t_first - t_start
    log(f"time-to-first-field {ttff:.2f} s; all {n} pairs {t_all - t_start:.2f} s")
    return {"metric": "time_to_first_field_s", "value": round(ttff, 3), "unit": "s",
            "first_batch_s": round(parts["first_batch_s"], 3),
            "engine_build_s": round(parts["engine_build_s"], 3), "n_pairs": n,
            "total_s": round(t_all - t_start, 3),
            "parts": {k: round(v, 4) for k, v in parts.items()},
            "kernel_load_s": round(kernel_load_s, 4),
            "kernel_loads": {name: {"s": round(k["s"], 4), "built": k["built"]}
                             for name, k in kernel_loads.items()},
            "before_script_s": round(t0 - t_start, 4),
            "first_batch_spans": span, "cache_dir": str(build_dir()),
            "native_decoder": decoder, "device": str(device), "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="time to first field of OfflinePIV")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:<i> or cpu; TPIV_DEVICE also names it")
    ap.add_argument("--folder", default=None,
                    help="the BMP pairs, made where missing or empty and otherwise "
                         "timed as they are")
    ap.add_argument("--use-pallas", default="auto", choices=("auto", "on", "off"))
    ap.add_argument("--make-dataset", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    n_pairs = int(os.environ.get("COLDSTART_PAIRS", N_PAIRS))
    batch = int(os.environ.get("COLDSTART_BATCH", BATCH))
    folder = args.folder or default_folder(n_pairs)
    if args.make_dataset:
        make_dataset(folder, n_pairs)
        return 0
    dt_ds = ensure_dataset(folder, n_pairs)
    if dt_ds:
        log(f"dataset made in {dt_ds:.1f} s (excluded from timing)")
    out = measure(args.device, folder, batch, args.use_pallas, T_PROC + dt_ds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
