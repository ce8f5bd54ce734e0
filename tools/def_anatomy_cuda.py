#!/usr/bin/env python3
"""What the time of the port's window-deformation kernel is made of, on one
card: edited copies of ``csrc/def_windows.cu``, built and timed beside the
committed one, as ``tools/shift_anatomy_cuda.py`` does for the window
shift (whose helpers it uses).

    python3 tools/def_anatomy_cuda.py

Each mode copies ``torchpiv_tpu_torch/kernels/csrc`` to a temporary
directory, edits the copy of ``def_windows.cu`` (``edited_sources``), builds
it with ``-Xptxas -v`` (all modes at once) and times ``def_windows`` at the
4 MP path's pass-2 shape: 2048² float32 frames, a batch of 4, 32 px windows
at 16 px overlap (16129 a frame), margin 2, centre shifts uniform in ±24 px
and gradients in ±0.05 px/px from a seed, both interpolations; CUDA events
over 20 launches.  The package's sources are not touched.

* ``full``: the kernel as committed; must equal ``def_reference`` bit for
  bit.
* ``stages1``: one tile buffer instead of two (each window's tile staged
  and waited for before it is computed, nothing overlapped); exact as
  well.
* ``nostage``: no tile copies: the windows are computed from whatever the
  buffers hold.
* ``nosample``: the tiles staged, one tile value a pixel stored instead of
  the sample.
* ``storeonly``: neither: the store floor with the launch's bookkeeping.

Prints the card's name and power limit first, then one line a mode and
interpolation: ms per launch, registers and spills.  Exits with 1 without
a card.
"""
from __future__ import annotations

import importlib.util
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS.parent))

from torchpiv_tpu_torch.kernels import _build  # noqa: E402
from torchpiv_tpu_torch.kernels.deform import launch  # noqa: E402
from torchpiv_tpu_torch.ops.deform import def_operands, def_reference  # noqa: E402

_spec = importlib.util.spec_from_file_location("shift_anatomy_cuda",
                                               TOOLS / "shift_anatomy_cuda.py")
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

SOURCES = _build.CSRC
KERNEL = "def_windows"
FRAME, BATCH, W, O, M = (2048, 2048), 4, 32, 16, 2

COPY = "      piv::cp_async4(tile + i * TP + j, src + (int64_t)i * Wp + j);\n"
SAMPLE = "            px[jj] = sample<kCubic>(tile, TP, pi, pj, ry, rx);\n"
NO_SAMPLE = "            px[jj] = tile[pi * TP + pj] * ry;\n"
EDITS = {
    "full": [],
    "stages1": [("constexpr int kStages = 2;", "constexpr int kStages = 1;")],
    "nostage": [(COPY, "      ;\n")],
    "nosample": [(SAMPLE, NO_SAMPLE)],
    "storeonly": [(COPY, "      ;\n"), (SAMPLE, NO_SAMPLE)],
}
EXACT = ("full", "stages1")  # modes whose output must equal the plain version's


def edited_sources(mode: str) -> dict:
    """``{"def_windows.cu": text}`` as committed with the edits of ``mode``
    applied; raises unless each edit's text occurs exactly once."""
    text = (SOURCES / "def_windows.cu").read_text()
    for old, new in EDITS[mode]:
        if text.count(old) != 1:
            raise RuntimeError(f"{mode}: def_windows.cu holds {text.count(old)} "
                               f"copies of {old!r}")
        text = text.replace(old, new)
    return {"def_windows.cu": text}


def edited_copy(mode: str) -> Path:
    """A temporary copy of the package's sources with ``mode``'s edits."""
    copy = Path(tempfile.mkdtemp(prefix=f"csrc_def_{mode}_"))
    for f in SOURCES.iterdir():
        shutil.copy(f, copy / f.name)
    for name, text in edited_sources(mode).items():
        (copy / name).write_text(text)
    return copy


def build(modes) -> dict:
    """Build every mode's copy, one ``nvcc`` each, all started together;
    returns ``{mode: (copy, ptxas log summary of the two instances)}``."""
    copies = {mode: edited_copy(mode) for mode in modes}
    started = {}
    for mode, copy in copies.items():
        with base.pointed_at(copy):
            _build._target(KERNEL).unlink(missing_ok=True)  # always report
            started[mode] = _build._start(KERNEL)
    out = {}
    for mode, copy in copies.items():
        with base.pointed_at(copy):
            log = _build._finish(KERNEL, started[mode])
        out[mode] = copy, [instance_summary(log, cubic) for cubic in (False, True)]
    return out


def instance_summary(log: str, cubic: bool) -> dict:
    """``ptxas_summary`` of the bilinear (``cubic=False``) or the bicubic
    instance's part of a ``ptxas -v`` log."""
    name = f"def_windows_kernelILb{int(cubic)}"
    for part in log.split("Compiling entry function")[1:]:
        if name in part.splitlines()[0]:
            return base.ptxas_summary(part)
    raise RuntimeError(f"ptxas reported no {name}")


def operands(frames: torch.Tensor, interp: str, seed: int = 0):
    """The pass-2 ``DefOperands`` of ``[B, 2048, 2048]`` frames on the card."""
    n = ((FRAME[0] - W) // (W - O) + 1) * ((FRAME[1] - W) // (W - O) + 1)
    g = torch.Generator().manual_seed(seed)
    maps = [(torch.rand(frames.shape[0], n, generator=g) * 2 - 1) * 24 for _ in range(2)]
    maps += [(torch.rand(frames.shape[0], n, generator=g) * 2 - 1) * 0.05
             for _ in range(4)]
    return def_operands(frames, *(m.to(frames.device) for m in maps),
                        frame_shape=FRAME, wind_size=W, overlap=O, margin=M,
                        interp=interp)


def measure(frames: torch.Tensor, modes=tuple(EDITS)) -> list:
    """Build and time every mode in both interpolations; the exact modes
    are held bit for bit against ``def_reference``.  One dict a mode and
    interpolation."""
    built = build(modes)
    rows = []
    for i, interp in enumerate(("bilinear", "bicubic")):
        ops = operands(frames, interp)
        plain = def_reference(ops, W)
        for mode, (copy, ptxas) in built.items():
            with base.pointed_at(copy):
                out = launch(ops, W)
                torch.cuda.synchronize()
                exact = torch.equal(out, plain)
                if mode in EXACT and not exact:
                    raise RuntimeError(f"{mode} {interp}: differs from def_reference")
                del out
                ms = base.cuda_ms(lambda: launch(ops, W))
            rows.append({"mode": mode, "interp": interp, "ms": ms, "bit_equal": exact,
                         **ptxas[i]})
            print(f"{interp:8s} {mode:9s} {ms:.4f} ms, {ptxas[i]['registers']} registers, "
                  f"spills {ptxas[i]['spill_stores']} B stored / "
                  f"{ptxas[i]['spill_loads']} B loaded"
                  + (" (bit-equal)" if exact else ""), flush=True)
        del plain
    for copy, _ in built.values():
        shutil.rmtree(copy)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("def_anatomy_cuda: no CUDA device", file=sys.stderr)
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
