#!/usr/bin/env python3
"""What the time of the port's pass-fusion kernels is made of, on one card.

    python3 tools/corrfit_anatomy_cuda.py [plans] [anatomy] [peakfit]

Each mode copies ``torchpiv_tpu_torch/kernels/csrc`` to a temporary
directory, edits the copy, builds it with the package's own ``kernels/_build.py`` and
times ``correlate_peakfit`` and ``fused_piv_pass`` at the pass shapes of the
4 MP path (batch of 4; pass 2: 64516 windows of 32 px, pass 1: 15876 of
64 px) on random windows and frames from a seed, CUDA events over 20
launches.  The package's sources are not touched.

* ``plans``: other factorisations and thread counts of ``Plan<W>`` in
  ``corrfit.cuh`` and other block sizes for the warp-owned windows, each
  with its registers and shared memory and its largest difference to the
  plain version on 2000 windows.
* ``anatomy``: the kernels with parts taken out (the fit; the inverse
  transforms; all transforms), so that differences between the lines say
  what each part costs.  The stripped kernels give wrong output by design.
* ``peakfit``: the ``peakfit`` kernel with and without its register bound,
  with what ``ptxas`` reports for each.

Prints the card's name and power limit first; exits with 1 without a card.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torchpiv_tpu_torch.kernels import _build, corrfit, fused_pass, peakfit  # noqa: E402
from torchpiv_tpu_torch.ops.corrfit import correlate_peakfit_reference  # noqa: E402
from torchpiv_tpu_torch.ops.shifts import shift_operands  # noqa: E402

FRAME = (2048, 2048)
BATCH = 4
SOURCES = _build.CSRC
FIT = "  fit_map(g, map, mn, W, W, vw, val_ratio, 1, u, v, invalid);"
NO_FIT = "  if (g.rank() == 0) { *u = mn; *v = map[5]; }"
INVERSE = "  fft_axis<W, true, false>(z, tw, g);\n  fft_axis<W, true, true>(z, tw, g);\n"
FORWARD = "  fft_rows_from<W>(z, tw, g, load);\n  fft_axis<W, false, false>(z, tw, g);\n"
# the rows still have to reach z where the product reads them
NO_FORWARD = ("  for (int p = g.rank(); p < N; p += g.size())\n"
              "    z[(p / W) * PITCH + (p & (W - 1))] = load(p / W, p & (W - 1));\n"
              "  g.sync();\n")


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def edited_copy(edits: dict) -> Path:
    """Point ``_build`` at a copy of the sources with ``{file: [(old,
    new), ...]}`` applied (``old`` a regular expression)."""
    copy = Path(tempfile.mkdtemp(prefix="csrc_"))
    for f in SOURCES.iterdir():
        shutil.copy(f, copy / f.name)
    for name, subs in edits.items():
        text = (copy / name).read_text()
        for old, new in subs:
            if not re.search(old, text):
                raise RuntimeError(f"{name}: nothing matches {old!r}")
            text = re.sub(old, lambda _: new, text, count=1)
        (copy / name).write_text(text)
    _build.CSRC = copy
    _build._loaded.clear()
    return copy


def plan(w: int, p: int, l: int, threads: int):
    return (rf"struct Plan<{w}> \{{[^}}]*\}}",
            f"struct Plan<{w}> {{ static constexpr int P = {p}, L = {l}, "
            f"THREADS = {threads}; }}")


class Shapes:
    def __init__(self, sizes=(32, 64)):
        g = torch.Generator().manual_seed(0)
        self.g = g
        self.frames = (torch.rand(BATCH, *FRAME, generator=g) * 255).cuda()
        self.windows, self.operands = {}, {}
        for w in sizes:
            o = w // 2
            n = ((FRAME[0] - w) // (w - o) + 1) ** 2
            self.windows[w] = tuple((torch.rand(BATCH * n, w, w, generator=g) * 255).cuda()
                                    for _ in range(2))
            maps = [(torch.rand(BATCH, n, generator=g) * 6 - 3).cuda() for _ in range(4)]
            kw = dict(frame_shape=FRAME, wind_size=w, overlap=o, flat_wrap=True)
            self.operands[w] = (shift_operands(self.frames, maps[0], maps[1], **kw),
                                shift_operands(self.frames, maps[2], maps[3], **kw))

    def line(self, label: str, sizes=None, check: bool = True) -> None:
        out = [label]
        for w in sizes or self.windows:
            a, b = self.windows[w]
            dc = w == 64  # pass 1 normalises by the windows' sums
            ms = cuda_ms(lambda: corrfit.launch(a, b, True, 1.2, 3, dc))
            off = cuda_ms(lambda: corrfit.launch(a, b, False, 1.2, 3, dc))
            oa, ob = self.operands[w]
            fused = cuda_ms(lambda: fused_pass.launch(oa, ob, w, True, 1.2, 3, dc))
            info = corrfit.describe("corrfit", w)
            err = ""
            if check:
                got = corrfit.launch(a[:2000], b[:2000], True, 1.2, 3, False)
                want = correlate_peakfit_reference(a[:2000], b[:2000], True, 1.2, 3, False)
                err = " max|u,v - plain| %.1e" % max(
                    (got[i] - want[i]).abs().max().item() for i in (0, 1))
            out.append(f"w{w}: correlate_peakfit {ms:.4f} ms (validate off {off:.4f}), "
                       f"fused_piv_pass {fused:.4f} ms, {info['registers']} registers, "
                       f"{info['local_bytes']} B local, {info['shared_bytes']} B shared{err}")
        print(" | ".join(out), flush=True)


def mode_plans() -> None:
    s = Shapes((32, 64, 128))
    block = (r"BLOCK = WARP \? 128", "BLOCK = WARP ? %d")
    edited_copy({})
    s.line("as committed")
    for label, subs, sizes in (
            ("blocks of 64 threads", [(block[0], block[1] % 64)], (32,)),
            ("blocks of 256 threads", [(block[0], block[1] % 256)], (32,)),
            ("w32 = 8 x 4", [plan(32, 8, 4, 32)], (32,)),
            ("w32 = 16 x 2", [plan(32, 16, 2, 32)], (32,)),
            ("w64 on 512 threads, w128 on 1024", [plan(64, 8, 8, 512),
                                                  plan(128, 16, 8, 1024)], (64, 128)),
            ("w64 = 16 x 4, w128 on 256 threads", [plan(64, 16, 4, 256),
                                                   plan(128, 16, 8, 256)], (64, 128)),
            ("w64 = 32 x 2 on 128 threads, w128 = 32 x 4", [plan(64, 32, 2, 128),
                                                            plan(128, 32, 4, 512)], (64, 128))):
        edited_copy({"corrfit.cuh": subs})
        s.line(label, sizes)


def mode_anatomy() -> None:
    s = Shapes()
    edited_copy({})
    s.line("whole kernels")
    esc = re.escape
    steps = [("without the fit", [(esc(FIT), NO_FIT)]),
             ("... and without the inverse transforms", [(esc(INVERSE), "")]),
             ("... and without any transform (loads, product, map)",
              [(esc(FORWARD), NO_FORWARD)])]
    subs = []
    for label, more in steps:
        subs = subs + more
        edited_copy({"corrfit.cuh": subs})
        s.line(label, check=False)


def mode_peakfit() -> None:
    g = torch.Generator().manual_seed(0)
    maps = [(torch.rand(n, w, w, generator=g) * 50).cuda()
            for n, w in ((64516, 32), (15876, 64))]
    bound = (r"__launch_bounds__\(kThreads, kBlocksPerSM\)", "__launch_bounds__(kThreads)")
    for label, edits in (("with the register bound", {}),
                         ("without it", {"peakfit.cu": [bound]})):
        copy = edited_copy(edits)
        log = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(copy / "probe.so"), str(copy / "peakfit.cu")],
            capture_output=True, text=True)
        used = " ".join(l.strip() for l in (log.stdout + log.stderr).splitlines()
                        if "registers" in l or "spill" in l)
        times = ", ".join("w%d %.4f ms" % (m.shape[-1], cuda_ms(
            lambda: peakfit.launch(m, True, 1.2, 3, True), reps=50)) for m in maps)
        print(f"peakfit {label}: {times}; {used}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("corrfit_anatomy_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    modes = {"plans": mode_plans, "anatomy": mode_anatomy, "peakfit": mode_peakfit}
    for name in sys.argv[1:] or list(modes):
        if name not in modes:
            print(f"unknown mode {name!r}: one of {sorted(modes)}", file=sys.stderr)
            return 2
        print(f"--- {name}", flush=True)
        modes[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
