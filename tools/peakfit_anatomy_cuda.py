#!/usr/bin/env python3
"""What the time of the port's peak-fit kernel is made of, and where its
instances should change, on one card: edited copies of ``csrc/peakfit.cu``,
built and timed beside the committed one, as ``tools/shift_anatomy_cuda.py``
does for the window shift (whose helpers it uses).

    python3 tools/peakfit_anatomy_cuda.py

Each mode copies ``torchpiv_tpu_torch/kernels/csrc`` to a temporary
directory, edits the copy of ``peakfit.cu`` (``edited_sources``), builds it
with ``-Xptxas -v`` (all modes at once) and times the kernel on the
correlation maps of the 4 MP path's two passes: 4 synthetic particle pairs
of 2048², displacement (3.3, -2.1) px, from seeds; pass 2 64516 maps of
32² (32 px windows at 16 px overlap), pass 1 15876 maps of 64² (64 at 32,
normalised), with ``min_subtract`` and validation window 3; CUDA events
over 20 launches.  The package's sources are not touched.

* ``full``: the kernel as committed; u, v within 1e-5 px of the plain
  version and the masks equal.
* ``nosecond``: no second walk (no validation): the fit alone.
* ``loadonly``: the first walk keeps only a maximum of each sample and the
  warp writes it: the loads with the least work that keeps them.
* ``d32chunks``: 32² maps by the chunked instance (4 chunks of 8 slots,
  the band's chunks read back) instead of the map in registers; exact.
* ``d64ch16`` / ``d64ch4``: 64² maps in 8 chunks of 16 slots or 32 of 4
  instead of 16 of 8; exact.

Prints the card's name and power limit first, then one line a mode and
pass: ms per launch, the byte bound, and the registers and spills that
``ptxas`` reports for the instance that serves the pass.  Exits with 1
without a card.
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
from torchpiv_tpu_torch.kernels.peakfit import launch  # noqa: E402
from torchpiv_tpu_torch.ops.correlate import correlate_fft  # noqa: E402
from torchpiv_tpu_torch.ops.peakfit import correlation_to_displacement  # noqa: E402
from torchpiv_tpu_torch.ops.windows import extract_windows  # noqa: E402
from torchpiv_tpu_torch.utils.synthetic import particle_pair  # noqa: E402

_spec = importlib.util.spec_from_file_location("shift_anatomy_cuda",
                                               TOOLS / "shift_anatomy_cuda.py")
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

SOURCES = _build.CSRC
KERNEL = "peakfit"
FRAME, BATCH, DISPLACEMENT, VW = (2048, 2048), 4, (3.3, -2.1), 3
PASSES = {"pass2": (32, 16, False), "pass1": (64, 32, True)}  # w, overlap, normalise
H100_BYTES_PER_S = 3.35e12

SCAN = '''    if (!kRagged || lane + 32 * (slot0 + s) < kd) mn = min_nan(mn, c[s]);
    if (c[s] > best) {
      best = c[s];
      best_slot = slot0 + s;
    }
    cmax = fmaxf(cmax, c[s]);
'''
AFTER_REDUCE = "  if (isnan(mn)) {  // the whole warp: m is the first NaN, the fit NaN\n"
SECOND = "  if (invalid == nullptr) return;\n"
D32 = "    if ((d) <= 32) return fn<32, 1>(__VA_ARGS__);            \\\n"
D64 = "    if ((d) <= 64) return fn<8, 16>(__VA_ARGS__);            \\\n"
EDITS = {
    "full": [],
    "nosecond": [(SECOND, "  return;\n")],
    "loadonly": [(SCAN, "    best = fmaxf(best, c[s]);\n"),
                 (AFTER_REDUCE, "  if (lane == 0) u[n] = best;\n  return;\n" + AFTER_REDUCE)],
    "d32chunks": [(D32, D32.replace("fn<32, 1>", "fn<8, 4> "))],
    "d64ch16": [(D64, D64.replace("fn<8, 16>", "fn<16, 8>"))],
    "d64ch4": [(D64, D64.replace("fn<8, 16>", "fn<4, 32>"))],
}
EXACT = ("full", "d32chunks", "d64ch16", "d64ch4")  # must agree with the plain version
# the warp instance that serves each pass, by mode: (CH, MAXC)
INSTANCE = {"pass2": {"d32chunks": (8, 4)}, "pass1": {"d64ch16": (16, 8), "d64ch4": (4, 32)}}
COMMITTED = {"pass2": (32, 1), "pass1": (8, 16)}


def edited_sources(mode: str) -> dict:
    """``{"peakfit.cu": text}`` as committed with the edits of ``mode``
    applied; raises unless each edit's text occurs exactly once."""
    text = (SOURCES / "peakfit.cu").read_text()
    for old, new in EDITS[mode]:
        if text.count(old) != 1:
            raise RuntimeError(f"{mode}: peakfit.cu holds {text.count(old)} "
                               f"copies of {old!r}")
        text = text.replace(old, new)
    return {"peakfit.cu": text}


def edited_copy(mode: str) -> Path:
    """A temporary copy of the package's sources with ``mode``'s edits."""
    copy = Path(tempfile.mkdtemp(prefix=f"csrc_peakfit_{mode}_"))
    for f in SOURCES.iterdir():
        shutil.copy(f, copy / f.name)
    for name, text in edited_sources(mode).items():
        (copy / name).write_text(text)
    return copy


def instance_summary(log: str, ch: int, maxc: int) -> dict:
    """``ptxas_summary`` of the warp kernel's ``<ch, maxc>`` instance."""
    name = f"peakfit_warp_kernelILi{ch}ELi{maxc}E"
    for part in log.split("Compiling entry function")[1:]:
        if name in part.splitlines()[0]:
            return base.ptxas_summary(part)
    raise RuntimeError(f"ptxas reported no {name}")


def build(modes) -> dict:
    """Build every mode's copy, one ``nvcc`` each, all started together;
    returns ``{mode: (copy, {pass: ptxas summary of its instance})}``."""
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
        out[mode] = copy, {p: instance_summary(log, *INSTANCE[p].get(mode, COMMITTED[p]))
                           for p in PASSES}
    return out


def correlation_maps(device) -> dict:
    """``{pass: [N, w, w] maps}`` of the synthetic pairs on ``device``."""
    pairs = [particle_pair(FRAME, DISPLACEMENT, seed=100 + i) for i in range(BATCH)]
    a = torch.stack([torch.from_numpy(p[0]) for p in pairs]).float().to(device)
    b = torch.stack([torch.from_numpy(p[1]) for p in pairs]).float().to(device)
    out = {}
    for label, (w, o, dc) in PASSES.items():
        out[label] = correlate_fft(extract_windows(a, w, o), extract_windows(b, w, o),
                                   dc_normalize=dc).reshape(-1, w, w).contiguous()
    return out


def measure(maps: dict, modes=tuple(EDITS)) -> list:
    """Build and time every mode at both passes; the exact modes are held
    against the plain version (u, v within 1e-5 px, masks equal) and
    ``nosecond`` to the committed kernel's u, v.  One dict a mode and pass."""
    built = build(modes)
    rows = []
    for label, corr in maps.items():
        pu, pv, pi = correlation_to_displacement(corr, True, 1.2, VW, min_subtract=True)
        fu, fv, _ = launch(corr, True, 1.2, VW, True)
        bound = corr.numel() * 4 / H100_BYTES_PER_S * 1e3
        for mode, (copy, ptxas) in built.items():
            with base.pointed_at(copy):
                ku, kv, ki = launch(corr, mode != "nosecond", 1.2, VW, True)
                torch.cuda.synchronize()
                if mode in EXACT:
                    err = max((ku - pu).abs().max().item(), (kv - pv).abs().max().item())
                    if err > 1e-5 or not torch.equal(ki, pi):
                        raise RuntimeError(f"{mode} {label}: differs from the plain "
                                           f"version ({err} px)")
                elif mode == "nosecond" and not (torch.equal(ku, fu) and torch.equal(kv, fv)):
                    raise RuntimeError(f"nosecond {label}: another u, v")
                ms = base.cuda_ms(lambda: launch(corr, mode != "nosecond", 1.2, VW, True))
            summary = ptxas[label]
            rows.append({"mode": mode, "pass": label, "ms": ms, "bound_ms": bound,
                         **summary})
            print(f"{label} {mode:9s} {ms:.4f} ms (bound {bound:.4f}), "
                  f"{summary['registers']} registers, spills {summary['spill_stores']} "
                  f"B stored / {summary['spill_loads']} B loaded", flush=True)
    for copy, _ in built.values():
        shutil.rmtree(copy)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("peakfit_anatomy_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    measure(correlation_maps(torch.device("cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
