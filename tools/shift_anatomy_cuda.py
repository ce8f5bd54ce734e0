#!/usr/bin/env python3
"""What the time of the port's bilinear window-shift kernel is made of, on
one card: the counterpart of ``make_kernel`` in
``tools/bench_shift_anatomy.py``.

    python3 tools/shift_anatomy_cuda.py

Each mode copies ``torchpiv_tpu_torch/kernels/csrc`` to a temporary
directory, edits the copy of ``shift_windows.cu``
(``edited_sources``), builds it with the package's own ``kernels/_build.py``
(``-Xptxas -v`` added; all modes at once) and times ``shift_windows`` at the
4 MP path's pass-2 shape, the shape ``bench_shift_anatomy.py`` uses: 2048²
float32 frames, a batch of 4, 32 px windows at 16 px overlap (16129 a
frame), shifts clamped to S = 16 px, maps uniform in ±3 px from a seed; CUDA
events over 20 launches.  The package's sources are not touched.

* ``full``: the kernel as committed (a warp a window: each tile row one
  coalesced ``__ldg`` a slot, the right neighbour by ``__shfl_sync``, eight
  rows loaded ahead, the blend, a streaming store); must equal
  ``blend_reference`` and the package's ``shift_windows`` bit for bit.
* ``noshuffle``: the right neighbours loaded through L1 (a second
  ``__ldg`` a slot) instead of shuffled; must equal them too: it changes
  how the neighbour arrives, not which.
* ``rowbyrow``: one tile row loaded ahead instead of eight; exact as well.
* ``noblend``: loads and shuffles, then the shuffled right neighbour stored
  (no blend).
* ``loadonly``: loads, then ``t[0] * w11`` stored (the TPU ``loadonly``;
  the shuffles fall away with their only use).
* ``storeonly``: no tile loads, ``fx * fy`` stored to every pixel (the TPU
  ``storeonly``).

The last three give wrong output by design.  The TPU modes ``norowroll``,
``nolaneroll``, ``norolls``, ``rowfirst``, ``gather`` and ``unroll*`` have
no counterpart: they take apart the rolls that place a tile that a band DMA
brought in at (8, 128)-aligned offsets.  The CUDA kernel reads each
window's rows at their own origin, which any lane addresses at any offset,
so it has no rolls to remove; the neighbour exchange they stand for is the
shuffle that ``noshuffle`` replaces, and the unrolling is ``rowbyrow``'s.

Prints the card's name and power limit first, then one line a mode: ms per
launch, the byte bound, and the registers, shared memory and spills that
``ptxas`` reports for the copy's build.  Exits with 1 without a card.
"""
from __future__ import annotations

import contextlib
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torchpiv_tpu_torch.kernels import _build  # noqa: E402
from torchpiv_tpu_torch.kernels.shift import launch, shift_windows  # noqa: E402
from torchpiv_tpu_torch.ops.shifts import blend_reference, shift_operands  # noqa: E402

SOURCES = _build.CSRC
KERNEL = "shift_windows"
FRAME = (2048, 2048)
BATCH = 4
W, O = 32, 16
REACH = 3.0  # px: the maps are uniform in +-REACH
REPS = 20
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PTXAS = ("-Xptxas", "-v")

SHUFFLE = "    right[k] = __shfl_sync(kAll, x, (c + 1) & (G - 1), G);\n"
LOAD = "    v[k] = in_tile ? __ldg(p + G * k) : 0.0f;\n"
AHEAD = "constexpr int rows_ahead() { return K == 1 ? 8 : 4; }\n"
BLEND = ("        const float val = piv::blend_corners(top[k], top_right[k], below[u][k],\n"
         "                                             below_right[k], blend);\n")
EDITS = {
    "full": {},
    "noshuffle": {"shift_windows.cu": [
        (SHUFFLE, "    right[k] = c + G * k < w ? __ldg(row + c + G * k + 1) : x;\n")]},
    "rowbyrow": {"shift_windows.cu": [(AHEAD, AHEAD.replace("K == 1 ? 8 : 4", "1"))]},
    "noblend": {"shift_windows.cu": [(BLEND, "        const float val = top_right[k];\n")]},
    "loadonly": {"shift_windows.cu": [
        (BLEND, "        const float val = top[k] * blend.w11;\n")]},
    "storeonly": {"shift_windows.cu": [
        (LOAD, "    v[k] = 0.0f;\n"), (BLEND, "        const float val = blend.w22;\n")]},
}
EXACT = ("full", "noshuffle", "rowbyrow")  # modes whose output must equal the plain version's


def edited_sources(mode: str) -> dict:
    """``{file: text}`` of ``shift_windows.cu`` and ``shift.cuh`` as
    committed, with the edits of ``mode`` applied; raises unless each edit's
    text occurs exactly once."""
    out = {}
    for name in ("shift_windows.cu", "shift.cuh"):
        text = (SOURCES / name).read_text()
        for old, new in EDITS[mode].get(name, ()):
            if text.count(old) != 1:
                raise RuntimeError(f"{mode}: {name} holds {text.count(old)} "
                                   f"copies of {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def edited_copy(mode: str) -> Path:
    """A temporary copy of the package's sources with ``mode``'s edits."""
    copy = Path(tempfile.mkdtemp(prefix=f"csrc_{mode}_"))
    for f in SOURCES.iterdir():
        shutil.copy(f, copy / f.name)
    for name, text in edited_sources(mode).items():
        (copy / name).write_text(text)
    return copy


@contextlib.contextmanager
def pointed_at(copy: Path):
    """``_build`` reads ``copy`` and compiles with ``-Xptxas -v`` inside the
    block; both are restored after it, and the loaded libraries dropped."""
    saved = _build.CSRC, _build.NVCC_FLAGS
    _build.CSRC, _build.NVCC_FLAGS = copy, saved[1] + PTXAS
    _build._loaded.clear()
    try:
        yield
    finally:
        _build.CSRC, _build.NVCC_FLAGS = saved
        _build._loaded.clear()


def ptxas_summary(log: str) -> dict:
    """Registers a thread, static shared memory and spill bytes from
    ``ptxas -v``'s report of the one kernel of the source (it names no
    ``smem`` when the kernel has none)."""
    def number(pattern, absent=None):
        m = re.search(pattern, log)
        return int(m.group(1)) if m else absent
    return {"registers": number(r"Used (\d+) registers"),
            "static_shared_bytes": number(r"(\d+) bytes smem", absent=0),
            "spill_stores": number(r"(\d+) bytes spill stores"),
            "spill_loads": number(r"(\d+) bytes spill loads")}


def main_instance(log: str) -> str:
    """The part of a ``ptxas -v`` log that reports the instance the 4 MP
    path's pass 2 runs: one column a lane, float32 stores
    (``shift_windows_kernel<1, float>``)."""
    for part in log.split("Compiling entry function")[1:]:
        if "shift_windows_kernelILi1EfE" in part.splitlines()[0]:
            return part
    raise RuntimeError("ptxas reported no shift_windows_kernel<1, float>")


def build(modes) -> dict:
    """Build every mode's copy, one ``nvcc`` each, all started together;
    returns ``{mode: (copy, ptxas summary of the main instance)}``."""
    copies = {mode: edited_copy(mode) for mode in modes}
    started = {}
    for mode, copy in copies.items():
        with pointed_at(copy):
            _build._target(KERNEL).unlink(missing_ok=True)  # always report
            started[mode] = _build._start(KERNEL)
    out = {}
    for mode, copy in copies.items():
        with pointed_at(copy):
            out[mode] = copy, ptxas_summary(
                main_instance(_build._finish(KERNEL, started[mode])))
    return out


def cuda_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def operands(frames: torch.Tensor, seed: int = 0):
    """The pass-2 ``ShiftOperands`` of ``[B, 2048, 2048]`` float32 frames on
    the card, with maps uniform in ±3 px from ``seed``."""
    n = ((FRAME[0] - W) // (W - O) + 1) * ((FRAME[1] - W) // (W - O) + 1)
    g = torch.Generator().manual_seed(seed)
    vx, vy = ((torch.rand(frames.shape[0], n, generator=g) * 2 - 1) * REACH
              for _ in range(2))
    return shift_operands(frames, vx.to(frames.device), vy.to(frames.device),
                          frame_shape=FRAME, wind_size=W, overlap=O)


def byte_bound_ms(ops) -> float:
    """Each input read once, each output written once: the padded frames,
    four maps, the windows."""
    B, Hp, Wp = ops.frame.shape
    n = ops.n_rows * ops.n_cols
    return B * (Hp * Wp * 4 + n * 4 * 4 + n * W * W * 4) / H100_BYTES_PER_S * 1e3


def measure(ops, modes=tuple(EDITS)) -> list:
    """Build and time every mode on ``ops``; the exact modes are held
    bit for bit against ``blend_reference`` and the package's kernel.
    Returns one dict a mode."""
    plain = blend_reference(ops, W)
    package = launch(ops, W)
    torch.cuda.synchronize()
    if not torch.equal(package, plain):
        raise RuntimeError("the package's shift_windows differs from blend_reference")
    bound = byte_bound_ms(ops)
    rows = []
    for mode, (copy, ptxas) in build(modes).items():
        with pointed_at(copy):
            before = shift_windows.launches
            out = launch(ops, W)
            torch.cuda.synchronize()
            err = (out - plain).abs().max().item()
            exact = torch.equal(out, plain) and torch.equal(out, package)
            if mode in EXACT and not exact:
                raise RuntimeError(f"{mode}: max |kernel - plain| = {err}")
            del out
            ms = cuda_ms(lambda: launch(ops, W))
            launches = shift_windows.launches - before
        shutil.rmtree(copy)
        dynamic = 0  # no mode stages the tile in shared memory
        rows.append({"mode": mode, "ms": ms, "bound_ms": bound,
                     "max_abs_err": err, "bit_equal": exact, "launches": launches,
                     "dynamic_shared_bytes": dynamic, **ptxas})
        print(f"{mode:9s} {ms:.4f} ms, bound {bound:.4f} ms (bytes), "
              f"{ptxas['registers']} registers, {ptxas['static_shared_bytes']} B static "
              f"+ {dynamic} B dynamic shared, spills {ptxas['spill_stores']} B stored / "
              f"{ptxas['spill_loads']} B loaded; max |out - plain| {err!r}"
              + (" (bit-equal)" if exact else ""), flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("shift_anatomy_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    g = torch.Generator().manual_seed(1)
    frames = torch.randint(0, 256, (BATCH, *FRAME), generator=g).float().cuda()
    measure(operands(frames))
    return 0


if __name__ == "__main__":
    sys.exit(main())
