#!/usr/bin/env python3
"""How many tile rows the window shifts on ``csrc/warp_lanes.cuh``'s lane
map should load at a time, on one card: edited copies of
``csrc/shift_windows_bicubic.cu``, ``csrc/shift_windows_phases.cu`` and
``csrc/shift_windows_bf16.cu`` with other ``rows_ahead`` for one column a
lane (w <= 32, the instance of the main paths), built and timed beside the
committed ones, as
``tools/shift_anatomy_cuda.py`` does for the bilinear shift (whose helpers
it uses).

    python3 tools/warp_shift_depth_cuda.py

Each depth copies ``torchpiv_tpu_torch/kernels/csrc`` to a temporary
directory, edits the copy's ``rows_ahead``, builds it with ``-Xptxas -v``
(all copies at once) and times the kernel at the 4 MP path's pass-2 shape:
2048² frames of 8-bit grey levels, a batch of 4, 32 px windows at 16 px
overlap (16129 a frame), shifts uniform in ±24 px from a seed (past the
±16 px clamp), CUDA events over 20 launches.  Every depth must equal the
plain version bit for bit: the depth changes when a row is loaded, not
which.  The bicubic kernel's ring of row sums is indexed by the tile row
modulo 4, so its depths are multiples of 4.  The package's sources are not
touched.

Prints the card's name and power limit first, then one line a kernel and
depth: ms per launch, and the registers and spill bytes that ``ptxas``
reports for the one-column instance.  Exits with 1 without a card.
"""
from __future__ import annotations

import importlib.util
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS.parent))

from torchpiv_tpu_torch.kernels import _build  # noqa: E402
from torchpiv_tpu_torch.kernels.shift import (launch, launch_variant,  # noqa: E402
                                              variant_frame)
from torchpiv_tpu_torch.ops.shifts import (blend_reference_bicubic,  # noqa: E402
                                           blend_reference_variant,
                                           shift_operands)

_spec = importlib.util.spec_from_file_location("shift_anatomy_cuda",
                                               TOOLS / "shift_anatomy_cuda.py")
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

FRAME, BATCH, W, O = (2048, 2048), 4, 32, 16
DEPTHS = {"shift_windows_bicubic": (4, 8, 12, 16),
          "shift_windows_phases": (4, 6, 7, 8),
          "shift_windows_bf16": (4, 6, 7, 8)}
AHEAD = re.compile(r"constexpr int rows_ahead\(\) \{ return K == 1 \? (\d+) : 4; \}")


def edited_copy(name: str, depth: int) -> Path:
    """A temporary copy of the package's sources whose ``name.cu`` loads
    ``depth`` rows at a time for one column a lane."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    if len(AHEAD.findall(text)) != 1:
        raise RuntimeError(f"{name}.cu: no single rows_ahead to edit")
    copy = Path(tempfile.mkdtemp(prefix=f"csrc_{name}_{depth}_"))
    for f in _build.CSRC.iterdir():
        shutil.copy(f, copy / f.name)
    (copy / f"{name}.cu").write_text(AHEAD.sub(
        f"constexpr int rows_ahead() {{ return K == 1 ? {depth} : 4; }}", text))
    return copy


def one_column_summary(log: str) -> dict:
    """``ptxas_summary`` of the one-column instance (``kernel<1>``)."""
    for part in log.split("Compiling entry function")[1:]:
        if "_kernelILi1EE" in part.splitlines()[0]:
            return base.ptxas_summary(part)
    raise RuntimeError("ptxas reported no one-column instance")


def build() -> dict:
    """Every kernel and depth built, one ``nvcc`` each, all started
    together; ``{(name, depth): (copy, ptxas summary)}``."""
    copies = {(n, d): edited_copy(n, d) for n, ds in DEPTHS.items() for d in ds}
    started = {}
    for (name, depth), copy in copies.items():
        with base.pointed_at(copy):
            _build._target(name).unlink(missing_ok=True)  # always report
            started[name, depth] = _build._start(name)
    out = {}
    for (name, depth), copy in copies.items():
        with base.pointed_at(copy):
            log = _build._finish(name, started[name, depth])
        out[name, depth] = copy, one_column_summary(log)
    return out


def measure(frames: torch.Tensor) -> list:
    """Build and time every kernel and depth; one dict each."""
    n = ((FRAME[0] - W) // (W - O) + 1) * ((FRAME[1] - W) // (W - O) + 1)
    g = torch.Generator().manual_seed(0)
    vx, vy = ((torch.rand(BATCH, n, generator=g) * 48 - 24).to(frames.device)
              for _ in range(2))
    kw = dict(frame_shape=FRAME, wind_size=W, overlap=O)
    cubic = shift_operands(frames, vx, vy, interp="bicubic", **kw)
    linear = shift_operands(frames, vx, vy, **kw)
    vframe = {v: variant_frame(linear, v) for v in ("phases", "bf16")}
    runs = {"shift_windows_bicubic": (lambda: launch(cubic, W, "bicubic"),
                                      blend_reference_bicubic(cubic, W))}
    for v in vframe:
        runs[f"shift_windows_{v}"] = (
            lambda v=v: launch_variant(linear, W, v, frame=vframe[v]),
            blend_reference_variant(linear, W, v))
    rows = []
    for (name, depth), (copy, ptxas) in build().items():
        fn, plain = runs[name]
        with base.pointed_at(copy):
            out = fn()
            torch.cuda.synchronize()
            if not torch.equal(out, plain):
                raise RuntimeError(f"{name} rows_ahead {depth}: not the plain version")
            del out
            ms = base.cuda_ms(fn)
        shutil.rmtree(copy)
        rows.append({"kernel": name, "rows_ahead": depth, "ms": ms, **ptxas})
        print(f"{name} rows_ahead {depth:2d}: {ms:.4f} ms, {ptxas['registers']} "
              f"registers, spills {ptxas['spill_stores']} B stored / "
              f"{ptxas['spill_loads']} B loaded (bit-equal)", flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("warp_shift_depth_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    g = torch.Generator().manual_seed(1)
    frames = torch.randint(0, 256, (BATCH, *FRAME), generator=g).float().cuda()
    measure(frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
