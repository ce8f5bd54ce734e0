#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``torchpiv_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each failing loudly:

1. environment: torch/CUDA versions, the card's name and power limit, TF32
   off;
2. build every CUDA kernel of the package from its sources, and print what
   the compiler made of each instance of the two pass-fusion kernels, of
   the window shifts, the deformation and the peak fit (registers a
   thread, shared memory a block; no instance may spill); build the native
   bulk decoder with ``g++`` (fails if it does not build);
3. each kernel (bilinear and bicubic window shift, the four bilinear shift
   variants, window deformation, fused peak fit, correlate-and-fit, whole
   pass) against its plain PyTorch
   version on the card, at the main paths' shapes (2048x2048 frames, pass 2:
   w32/o16, a batch of 4; the fits at pass 1, w64/o32, too, and the two
   pass-fusion kernels at w16/o8 and w128/o64 as well: the instances with
   several windows a block and with the most shared memory), with times:
   kernel, plain version, bound, and a yardstick that computes the same
   function where there is one (``grid_sample`` bilinear; for the two
   pass-fusion kernels the port's own unfused chain); the packed output of
   the window shift against the repacked standard output; the window
   shifts (bilinear and bicubic) and the deformation bit for bit, timed on
   random maps and on smooth ones like the main path's pass 2, and they,
   ``"phases"`` (no phase table: its peak memory above its inputs is
   checked) and the other redesigned kernels beside their readings before
   the redesign (``EARLIER_MS``); every shift
   variant also against the ``rolls`` kernel (bit-equal on 8-bit frames)
   and on a float-valued frame, where the bfloat16 variants must differ;
   the shift wrappers' device times (queued behind a spin kernel, so the
   host's pace does not enter) and peak memory side by side (``"bf16"``,
   which reads the float32 frame, within ``MARGIN_MS`` of ``rolls`` by the
   medians of five rounds timed in turns); every variant also timed on the
   smooth maps, and ``"lanephases"`` beside the copy-engine ring it was
   measured against (``tools/lanephases_ring_cuda.py``, bit-equal);
4. the first path: ``OfflinePIV`` over 8 synthetic 2048x2048 BMP pairs with
   a uniform displacement, 64 px windows, 32 px overlap, 2-pass CWS; checks
   the recovered displacement, the valid share and the kernel launch
   counts, and prints pairs/s;
5. the DEF path: ``OfflinePIV`` over 8 sheared pairs, 2-pass DEF with the
   fused peak fit; checks the recovered shear, the valid share and the
   launch counts, and prints pairs/s beside the same run with the torch-op
   peak fit; then one batch each of CWS + bicubic and DEF + bicubic;
6. the pass-fusion paths: ``OfflinePIV`` over the 8 uniform pairs with
   ``fused="split"`` and with ``fused="on"`` (displacement, valid share and
   exact launch counts), and one batch of ``fused="split"`` + DEF over the
   sheared pairs; the shift-variant paths: the 8 uniform pairs with
   ``shift_variant="bf16"``, one batch each of the other three variants and
   one of ``fused="split"`` + ``"bf16"``, fields equal to the ``rolls``
   runs' bit for bit; the robust path: 8 uniform pairs with corrupted
   patches and a region-of-interest mask, ``shift_variant="phases"``, the
   median filter, velocity limits, the global sigma test and the
   second-peak fallback, then one batch each of RPC + Gaussian window
   weights, the gauss2d fit and ``infill="fused"``;
7. the engine's time per batch, its device time by kernel and its peak
   device memory: CWS unfused, ``split`` and ``on`` (no FFT-library kernel
   and no ``fftshift`` roll may appear in the fused profiles), DEF with
   both peak fits, the robust configuration, CWS + bicubic and
   ``infill="fused"``;
8. the CUDA engine against the CPU engine (plain versions) on one full-size
   pair: CWS, DEF, DEF and CWS with bicubic resampling, ``split``, ``on``
   and the robust configuration;
9. the mesh (``parallel``): the seven resampling kernels at the pass-2
   shape on 2 and 4 blocks of window rows (``row_start``/``n_rows_local``,
   the clamped blocks of ``ShardedPIV``, flat-wrap on and off), every block
   bit-equal to the same rows of the full launch and to its plain version,
   timed against the full launch; ``OfflinePIV`` over a one-device mesh,
   bit-equal to the unsharded run, also with ``background="auto"`` (one
   batch of the rough pairs, its host spans printed); window splits over the one card named 2
   and 4 times (``{"pairs": 1, "windows": 2}``, ``{"pairs": 2, "windows":
   2}``): displacement, valid share, launch counts and the parity budget
   against the unsharded engine; one batch each of DEF (with the fused peak
   fit), CWS + bicubic and the four shift variants under the window split;
   the sharded engines' device ms and launches a batch (``torch.profiler``)
   beside the unsharded one and the window-split table of
   ``parallel.meshprof``; a one-rank NCCL group through
   ``initialize_distributed`` in a child process;
10. the streaming front ends, the runner and the service at the same full
   width (``phase_streaming``): ``OnlinePIV`` with the ``frame_shape`` hint
   while a writer thread renames the 8 uniform pairs into an empty folder
   at 8 pairs a second (each frame written under a name the watcher
   ignores, then ``os.replace``d), then with all 8 renamed in at once
   (two catch-up calls of 4): displacement, valid share, exact launch
   counts, the parity budget against ``OfflinePIV``, the pairs that went
   single and in catch-up and the latency from each ``_b`` rename to its
   field; ``VideoPIV`` over the 16 frames (an FFV1 video where OpenCV is
   installed, else ``video_stand_in`` over the decoded frames), bit-equal
   to ``OfflinePIV`` at batch 4, also with a short last batch; ``PIVRunner``
   with per-pair text saves and a checkpoint, its table's mean velocity
   against the mean of ``OfflinePIV``'s fields; ``PIVService`` behind
   ``make_server`` driven by ``PIVClient`` with ``TPIV_SERVE_SCAN_B=4``
   (one pair, the burst bit-equal to ``OfflinePIV``, a file pair, health,
   config and metrics, request and per-pair latencies), and a second
   service with ``fused="on"`` (row 6's launches exact).  Every reading
   carries the card's name and power limit;
11. the other device-path models at the same full width
   (``phase_models``): ``EnsemblePIV`` over 16 sparse pairs (density
   0.002, seeds 200-215; single pass, w64/o32, both peak fits: mean
   displacement, valid share beside the single-pair engine's, the fused
   peak fit launched once a field with ``peakfit="pallas"`` and never
   with ``"xla"``, ``corr_batch`` over two batches of 8 against one call,
   device ms); ``MultiDtPIV`` on a 5-frame ``render_particles`` sequence
   at 0.8 px/frame, separations (1, 2, 4), 2-pass CWS (u, ``dt_map``, the
   shift kernel launched twice for the one batched engine call);
   ``FolkiPIV`` dense on the first uniform pair (the JAX test's gates) and
   hybrid on an (11, 0) px pair with a 2-pass CWS engine; ``PTV`` at PTV
   seeding (density 0.003, capacity 16384), plain, guided, and guided with
   the left half masked (no detection inside), ``bin_to_grid`` of the
   guided tracks, detection device ms beside matching host ms; the quality
   maps (median peak width against the 1.50 px the particles imply) and
   the SAD matchers timed at the pass-1 shape; then each model and map on
   one 1024x1024 pair on the card against the CPU.  Every reading carries
   the card's name and power limit;
12. the command line ``tpiv-torch`` at the same full width
   (``phase_cli``): ``run`` over the 8 uniform pairs in this process (the
   launch counts set to 0 just before and read just after: rows 1-3 only
   through the CLI, each per-pair text table equal to phase 4's field at
   the saved precision), the same ``run`` as ``python -m
   torchpiv_tpu_torch.cli`` in a fresh interpreter (its wall seconds: the
   cold start), ``run --multipass-mode DEF`` over the sheared pairs (row
   3, the shear gate) and ``run --cws-interp bicubic`` over one batch of
   them (row 2), ``warmup 2048x2048 --multipass 2``, ``doctor --cache``
   (every check passes; its first fresh process builds ``fastio`` and
   ``shift_windows.cu``, the second builds nothing), ``qc`` over 2 pairs,
   ``ensemble`` over the 8 (the uniform displacement) and ``bench`` cut to
   ``BENCH_PAIRS=16 BENCH_REPEATS=2`` (its JSON line printed, no claim);
13. the JAX engine's XLA resampling paths at the same full width
   (``phase_xla_paths``): (a) the 8 uniform pairs (the sheared ones for
   DEF) through ``OfflinePIV(..., engine_options={"use_pallas": "off"})``
   with 2-pass CWS, DWS, DEF, CWS + bicubic, ``fused="split"`` and
   ``peakfit="pallas"`` (displacement, valid share, exact launch counts:
   no resampling kernel, row 5 or row 4 once a pass; the RMS against
   ``"auto"`` on the first batch, the device ms and peak memory a batch
   beside phase 7's kernel paths, the card against the CPU engine);
   (b) windows beyond the kernels' limits at ``"auto"``: DEF w256/o128 on
   the sheared pairs and bicubic w256/o128 (their kernels never launch),
   w512/o256 3-pass (row 1 on pass 3 only), and the limit cases bicubic
   w250/o124 and DEF w248/o124 (rows 2 and 3 launch); (c) the
   camera-degraded campaign: the moderate and harsh tiers of
   ``tools/degraded_campaign.py`` (6 pairs each, ``camera_degraded_pair``)
   through ``OfflinePIV`` with SCC, RPC and the second-peak fallback at
   ``"off"`` and SCC at ``"auto"`` (pairs yielded, bad %, RMS of the good
   vectors and of all; moderate SCC yields all pairs with bad < 1% and
   RMS(good) < 0.3 px, harsh RPC and fallback yield more pairs than harsh
   SCC), and one harsh pair on the card against the CPU engine, through the
   functions of ``tools/degraded_campaign_cuda.py``;
14. the user-facing scripts beside the package (``phase_scripts``):
   ``tools/sustained_run_cuda.py`` at its defaults (4,000 pairs of
   2048x2048, batch 8, the host tail on every pair; every repeat of a
   unique pair gives that pair's first digest, each unique pair's mean
   within 0.05 px, row 1's launches exact), ``tools/coldstart_cuda.py`` in
   fresh interpreters (warm, with an empty ``TORCHPIV_CACHE_DIR``, warm
   again; 48 pairs at 4 MP; row 1 alone loads, at its first launch, and
   only it and the decoder are built into the empty cache), ``tools/accuracy_table_cuda.py``'s table and
   sections at ``"auto"`` (every cell finite, peak locking under 0.05 px,
   DEF below CWS on the shear, rows 1-3 launched), the five
   ``examples/*_cuda.py`` through ``main`` on the card and their ``run``
   on the card against the CPU (the parity budget; PTV phase 11's gates),
   and ``tools/degraded_campaign_cuda.py`` at its defaults (512x512, 6
   pairs, both tiers);
15. the per-configuration sweep, the settings A/B and the op attribution
   (``phase_tools``): ``tools/bench_sweep_cuda.py``'s six configurations
   at batch 8 and the headline configuration at batches 4-32 (medians of 2;
   no ``FAILED`` row, every grid the engine's ``final_field_shape``, rows 1
   and 3 launched), ``tools/bench_engine_ab_cuda.py`` with ``off`` against
   ``split`` and the default against ``correlator=matmul,
   dft_precision=default`` (masks agreeing on 98% of the windows, RMS
   below 0.01 px), and ``tools/profile_engine_cuda.py`` for CWS and DEF
   with one traced dispatch of 8 (the grouped device ms within 10% of the
   same dispatch's CUDA-event ms, a group for the shift or deformation
   kernel), on one set of 4 unique 2048x2048 pairs.

Phase 3 also holds the bfloat16 and float16 window stores (``out_dtype``)
of rows 1-3 (the bilinear shift, standard and packed, the bicubic shift and
the deformation with both interpolations) bit for bit against their plain
versions cast with ``.to()``, each timed beside its float32 store with the
bound for the narrower store (``phase_store_types``; ``stores`` in the
kernels line).  Phase 8 also runs the engines whose resampling kernels
store bfloat16 windows (``correlator="matmul", dft_precision="default"``:
CWS, DWS, DEF, CWS + bicubic and DEF + ``fused="split"``) against the CPU
engine.

Phase 3 also runs ``tools/shift_anatomy_cuda.py``'s six modes of the
window-shift kernel at pass 2 (``full``, ``noshuffle`` and ``rowbyrow``
bit-equal to the plain version).  Phase 7 prints the CWS and DEF engines'
device time beside their readings before the resampling kernels'
redesign (``EARLIER_DEVICE_MS``).  Phases 4 and 6 print the pipeline's host spans per batch
(``OfflinePIV.span_log``) on the CWS, ``split`` and ``on`` paths, and the
busy share they give.  After phase 6: the serial loop the pipeline replaced
(``serial_yardstick``) against the three-stage pipeline, in turns (serial,
pipelined, pipelined, serial) over 64 pairs that are hard links to the 8
uniform ones (decode runs for every pair, from the page cache), for CWS
and ``fused="on"``, with bit-equal fields; one batch of ``background=
"auto"`` over the rough pairs, bit-equal to frames cleaned on the host; one
batch of ``preprocess="clahe"``.  Every ``OfflinePIV`` path prints the
decoder it used.  After the turns: the native bulk decoder against the
Python one over the same 64 linked pairs, in turns, CWS and ``fused="on"``:
fields bit-equal, decode ms and the feeder's issue ms a batch.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits with 1 and prints no result.  The window splits of phase 9 run on the
one card named more than once: they show the split's cost, not a
multi-device speed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12  # bfloat16 on the tensor cores, dense
DISPLACEMENT = (3.3, -2.1)  # px, +x right, +y down (the CWS path)
SHEAR = (1.0, 0.004)  # u = 1 + 0.004 y px, v = 0 (the DEF path)
FRAME = (2048, 2048)
N_PAIRS = 8  # uniform pairs, the CWS path
N_LINKED = 64  # pairs of the serial-against-pipelined turns: links to the 8
N_SHEAR_PAIRS = 8  # sheared pairs, the DEF path
BATCH = 4
N_PATCHES = 6  # corrupted patches a frame, the robust path
PATCH = 48  # their side in px
WALL = 256  # columns that the robust path's mask excludes, from the left
ROBUST = dict(median_filter="normmedian", u_limits=(-8.0, 8.0),
              v_limits=(-8.0, 8.0), global_std=5.0, second_peak_fallback=True)
# ms per launch that this script read on an NVIDIA H100 80GB HBM3 at 700 W
# before the kernels of these rows were redesigned (printed beside this
# run's readings, never into the kernels line)
EARLIER_MS = {"correlate_peakfit": {"pass2": 2.213, "pass1": 1.827},
              "fused_piv_pass": {"pass2": 2.622, "pass1": 2.227},
              "shift_windows_mxu": {"pass2": 0.895},
              "shift_windows": {"pass2": 0.268},
              "def_windows": {"pass2": 0.432, "bicubic": 0.787},
              "shift_windows_bicubic": {"pass2": 0.456},
              "shift_windows_phases": {"pass2": 0.349},
              "peakfit": {"pass2": 0.244, "pass1": 0.204},
              "shift_windows_bf16": {"pass2": 0.224},
              "shift_windows_lanephases": {"pass2": 0.271}}
# a redesign must beat its earlier reading by more than this, and at most
# this share of its yardstick's time at pass 2 (the unfused chain; a
# shift's or a deformation's grid_sample)
MARGIN_MS = 0.02
YARDSTICK_SHARE = {"correlate_peakfit": 0.4, "fused_piv_pass": 0.4}
# what the redesigns aim at, ms (the resampling kernels at pass 2 on the
# random maps; printed, not checked: a miss must still beat EARLIER_MS)
TARGET_MS = {"shift_windows": {"pass2": 0.18},
             "def_windows": {"pass2": 0.25, "bicubic": 0.55},
             "shift_windows_bicubic": {"pass2": 0.22},
             "shift_windows_phases": {"pass2": 0.17},
             "peakfit": {"pass2": 0.13, "pass1": 0.13},
             "shift_windows_bf16": {"pass2": 0.18},
             "shift_windows_lanephases": {"pass2": 0.16}}
# the most that the "phases" wrapper may allocate above its inputs at pass
# 2: the padded float32 frame, its bfloat16 cast and pad, the windows (no
# phase table)
PHASES_PEAK_BYTES = 450e6
# the engines' device ms a batch of 4 (``phase_profile``) read on an NVIDIA
# H100 80GB HBM3 at 700 W before the last redesign of the kernels each
# engine runs: CWS by this script before shift_windows'; DEF
# peakfit=pallas and CWS shift_variant=bf16 by tools/engine_turns_cuda.py
# (the median of four) before peakfit's and shift_windows_bf16's
EARLIER_DEVICE_MS = {"CWS": 12.884, "DEF peakfit=pallas": 7.700,
                     "CWS shift_variant=bf16": 12.872}
SMOOTH_SLOPE = 0.002  # px/px of the smooth maps' gradient
FUSED_SHAPES = (("pass2", (32, 16), False), ("pass1", (64, 32), True),
                ("w16", (16, 8), False), ("w128", (128, 64), True))
VARIANT_LINES = {"bf16": 29, "lanephases": 111, "mxu": 195, "phases": 294}
CSRC = "torchpiv_tpu_torch/kernels/csrc/"
ANATOMY = "tools/shift_anatomy_cuda.py"
RING_TOOL = "tools/lanephases_ring_cuda.py"
ANATOMY_ROW = "shift_anatomy_full"
SPANS = ("decode_s", "pin_s", "h2d_ms", "load_s", "issue_s", "device_ms", "d2h_ms",
         "wait_s", "tail_s")


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


def queued_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, enqueued behind a
    spin kernel so that the card never waits for the host: a wrapper of
    several short launches is then timed by the card alone, not by how fast
    a shared host dispatches it.  The spin grows until the host has queued
    every call before it ends."""
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    while True:
        spin = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < 0.8 * spin.elapsed_time(start):
            return start.elapsed_time(end) / reps
        check(cycles < 2_000_000_000, f"the host took {host_ms} ms to queue {reps} calls")
        cycles *= 4


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
    from torchpiv_tpu_torch.native import loader

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {_build.sources()} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    check(loader.available(), "the native decoder did not build (g++)")
    log(f"native decoder: {loader.library_path()} in {time.perf_counter() - t0:.2f} s")
    from torchpiv_tpu_torch.kernels import deform, peakfit, shift
    from torchpiv_tpu_torch.kernels.corrfit import describe

    for name in ("corrfit", "fused_pass"):
        for w in (4, 8, 16, 32, 64, 128):
            info = describe(name, w)
            log(f"instance {name} w{w}: {json.dumps(info)}")
            check(info["local_bytes"] == 0, f"{name} w{w} spills: {info}")
    # the resampling kernels: one instance per columns a lane (the window
    # shifts), per interpolation (DEF)
    for name, widths in (("shift_windows", (16, 32, 64, 96, 128)),
                         ("shift_windows_bicubic", (16, 32, 64, 96, 125)),
                         ("shift_windows_phases", (16, 32, 64, 96, 128)),
                         ("shift_windows_bf16", (16, 32, 64, 96, 128)),
                         ("shift_windows_lanephases", (16, 32, 64, 96, 128))):
        for w in widths:
            info = shift.describe(w, name)
            log(f"instance {name} w{w}: {json.dumps(info)}")
            check(info["local_bytes"] == 0, f"{name} w{w} spills: {info}")
    # the peak fit: a warp a map, in registers up to 32 px, in chunks up to
    # 128; a block a map above
    for d in (4, 8, 16, 32, 64, 128, 200):
        info = peakfit.describe(d)
        log(f"instance peakfit d{d}: {json.dumps(info)}")
        check(info["local_bytes"] == 0, f"peakfit d{d} spills: {info}")
    for interp in ("bilinear", "bicubic"):
        for w, M in ((32, 2), (120, 1)):
            info = deform.describe(w, M, interp)
            log(f"instance def_windows {interp} w{w} M{M}: {json.dumps(info)}")
            check(info["local_bytes"] == 0, f"def_windows {interp} spills: {info}")


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


def roofline(n_bytes: float, n_flops: float, n_bf16_flops: float = 0.0):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and operations over the rate of their type (float32 outside the tensor
    cores, bfloat16 products on them)."""
    t_bytes = n_bytes / H100_BYTES_PER_S
    t_flops = n_flops / H100_F32_FLOPS + n_bf16_flops / H100_BF16_FLOPS
    return (max(t_bytes, t_flops) * 1e3,
            "bytes" if t_bytes >= t_flops else "operations")


def kernel_row(name, source, replaces, max_err, ms, plain_ms, n_bytes, n_flops,
               library_ms, n_bf16_flops=0.0, **extra) -> dict:
    bound_ms, bound_by = roofline(n_bytes, n_flops, n_bf16_flops)
    row = {"name": name, "route": "cuda", "source": CSRC + source,
           "replaces": replaces, "launches": None, "max_abs_err": max_err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms, **extra}
    log(json.dumps({"phase": name, **{k: row[k] for k in row if k not in (
        "route", "source", "replaces", "launches")},
        "bytes": n_bytes, "flops": n_flops}))
    return row


def window_count(w: int, o: int) -> int:
    H, W = FRAME
    return ((H - w) // (w - o) + 1) * ((W - w) // (w - o) + 1)


def shift_cases(n: int, g) -> dict:
    return {
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


def smooth_maps(w: int, o: int):
    """Per-window shifts ``[BATCH, N]`` like the main path's pass 2: the
    uniform ``DISPLACEMENT`` plus a gradient of ``SMOOTH_SLOPE`` px/px across
    the frame, so that neighbouring windows share their integer shift and
    their fractions move slowly; ``(vx, vy)``."""
    n_side = (FRAME[0] - w) // (w - o) + 1
    pos = torch.arange(n_side, dtype=torch.float32) * (w - o)
    pos = pos - pos.mean()
    row, col = pos[:, None], pos[None, :]
    vx = DISPLACEMENT[0] + SMOOTH_SLOPE * (col + row)
    vy = DISPLACEMENT[1] + SMOOTH_SLOPE * (row - col)
    return tuple(v.reshape(1, -1).expand(BATCH, -1).contiguous() for v in (vx, vy))


def phase_shift_kernels(frames: torch.Tensor) -> list:
    """``shift_windows`` (bilinear) and ``shift_windows_bicubic`` against
    their plain versions at the pass-2 shape, bit for bit; the bilinear
    kernel timed on the random maps and on smooth ones."""
    from torchpiv_tpu_torch.kernels.shift import launch, shift_windows
    from torchpiv_tpu_torch.ops.shifts import (blend_reference,
                                               blend_reference_bicubic,
                                               shift_operands)

    w, o = 32, 16
    n = window_count(w, o)
    dev = frames.device
    g = torch.Generator(device="cpu").manual_seed(0)
    cases = {**shift_cases(n, g), "smooth": smooth_maps(w, o)}
    rows = []
    for interp, plain, name in (
            ("bilinear", blend_reference, "shift_windows"),
            ("bicubic", blend_reference_bicubic, "shift_windows_bicubic")):
        kw = dict(frame_shape=FRAME, wind_size=w, overlap=o, interp=interp)
        max_err = 0.0
        for case, (vx, vy) in cases.items():
            vx, vy = vx.to(dev), vy.to(dev)
            got = shift_windows(frames, vx, vy, **kw)
            ops = shift_operands(frames, vx, vy, **kw)
            want = plain(ops, w)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            log(f"{name} {case}: max |kernel - plain| = {err!r}")
            # explicitly rounded sums in the plain version's order: nothing
            # is allowed, fractional shifts included
            check(torch.equal(got, want), f"{name} {case} must be bit-exact")
        if interp == "bicubic":  # integer shifts: the bilinear kernel's copy
            vx, vy = (t.to(dev) for t in cases["integer"])
            inside = (vx < w // 2) & (vy < w // 2)  # +S clamps the bilinear tile
            a = shift_windows(frames, vx, vy, **kw)
            b = shift_windows(frames, vx, vy, **dict(kw, interp="bilinear"))
            check(torch.equal(a[inside], b[inside]),
                  "bicubic integer shifts must equal the integer copy")

        vx, vy = (t.to(dev) for t in cases["fractional"])
        ops = shift_operands(frames, vx, vy, **kw)
        ms = cuda_ms(lambda: launch(ops, w, interp))
        smooth = shift_operands(frames, *(t.to(dev) for t in cases["smooth"]), **kw)
        smooth_ms = cuda_ms(lambda: launch(smooth, w, interp))
        log(f"{name}: {ms:.4f} ms on the random maps, {smooth_ms:.4f} ms on the "
            f"smooth ones")
        del smooth
        wrapper_ms = cuda_ms(lambda: shift_windows(frames, vx, vy, **kw))
        plain_ms = cuda_ms(lambda: plain(ops, w), reps=5)
        library_ms = None
        if interp == "bilinear":
            grid = shift_grid(ops, w)
            img = ops.frame[:, None]
            library_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
                img, grid, mode="bilinear", padding_mode="border",
                align_corners=True))
        # bicubic has no library call: grid_sample's bicubic is a = -0.75
        B, Hp, Wp = ops.frame.shape
        n_bytes = B * (Hp * Wp * 4 + n * 4 * 4 + n * w * w * 4)
        # a pixel: 4 products + 3 sums (bilinear); 4 rows of 4 products and
        # 4 sums, then 4 products and 4 sums (bicubic, as the plain version
        # writes it; the kernel forms each row's sums once: about 16.75)
        n_flops = B * n * w * w * (7 if interp == "bilinear" else 40)
        if name in EARLIER_MS:
            compare_with_earlier(name, {"pass2": dict(ms=ms, library_ms=library_ms)})
        rows.append(kernel_row(
            name, f"{name}.cu",
            "torchpiv_tpu/kernels/shift_pallas.py:" + ("44" if interp == "bilinear" else "166"),
            max_err, ms, plain_ms, n_bytes, n_flops, library_ms,
            wrapper_ms=wrapper_ms, smooth_ms=smooth_ms, shape=[B, Hp, Wp, n, w]))
    return rows


def phase_shift_variants(frames: torch.Tensor) -> list:
    """The four bilinear shift variants against their plain versions and the
    ``rolls`` kernel at the pass-2 shape; times beside ``rolls`` and
    ``grid_sample`` in the same run."""
    from torchpiv_tpu_torch.kernels.shift import (BF16_FRAME_VARIANTS,
                                                  VARIANT_WRAPPERS, launch,
                                                  launch_variant, shift_windows,
                                                  variant_frame)
    from torchpiv_tpu_torch.ops.shifts import (BF16_VARIANTS,
                                               blend_reference_variant,
                                               shift_operands)

    w, o = 32, 16
    n = window_count(w, o)
    dev = frames.device
    kw = dict(frame_shape=FRAME, wind_size=w, overlap=o)
    g = torch.Generator(device="cpu").manual_seed(5)
    cases = {k: tuple(t.to(dev) for t in v) for k, v in shift_cases(n, g).items()}
    # grey levels that are not exact in bfloat16
    float_frames = frames * 0.731 + 0.37
    rolls = {case: shift_windows(frames, vx, vy, **kw) for case, (vx, vy) in cases.items()}
    vx, vy = cases["fractional"]
    ops = shift_operands(frames, vx, vy, **kw)
    rolls_ms = cuda_ms(lambda: launch(ops, w))
    wrappers = {"rolls": wrapper_time_and_peak(
        lambda: shift_windows(frames, vx, vy, **kw))}
    grid = shift_grid(ops, w)
    img = ops.frame[:, None]
    library_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode="border", align_corners=True))
    del grid, img
    B, Hp, Wp = ops.frame.shape
    rows = []
    for variant in sorted(VARIANT_WRAPPERS):
        name = f"shift_windows_{variant}"
        rounds = variant in BF16_VARIANTS
        max_err = 0.0
        for case, (cx, cy) in cases.items():
            got = shift_windows(frames, cx, cy, variant=variant, **kw)
            want = blend_reference_variant(shift_operands(frames, cx, cy, **kw), w, variant)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            log(f"{name} {case}: max |kernel - plain| = {err!r}")
            # the blend rounds every product and sum in the plain version's
            # order: nothing is allowed, fractional shifts included
            check(torch.equal(got, want), f"{name} {case} must be bit-exact")
            # 8-bit grey levels are exact in bfloat16: the rolls kernel's output
            check(torch.equal(got, rolls[case]), f"{name} {case} != shift_windows")
            del got, want
        got = shift_windows(float_frames, vx, vy, variant=variant, **kw)
        fops = shift_operands(float_frames, vx, vy, **kw)
        want = blend_reference_variant(fops, w, variant)
        plain_rolls = shift_windows(float_frames, vx, vy, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        moved = (got - plain_rolls).abs().max().item()
        log(f"{name} float-valued frame: max |kernel - plain| = {err!r}, "
            f"max |kernel - shift_windows| = {moved!r}")
        check(torch.equal(got, want), f"{name} float-valued frame must be bit-exact")
        check((moved > 0.0) == rounds,
              f"{name}: the bfloat16 rounding of the frame shows as {moved}")
        del got, want, plain_rolls, fops

        vframe = variant_frame(ops, variant)
        ms = cuda_ms(lambda: launch_variant(ops, w, variant, frame=vframe))
        smooth = shift_operands(frames, *(t.to(dev) for t in smooth_maps(w, o)), **kw)
        sframe = variant_frame(smooth, variant)
        smooth_ms = cuda_ms(lambda: launch_variant(smooth, w, variant, frame=sframe))
        del smooth, sframe
        cast_ms = cuda_ms(lambda: variant_frame(ops, variant))
        wrapper_ms, peak = wrappers[variant] = wrapper_time_and_peak(
            lambda: shift_windows(frames, vx, vy, variant=variant, **kw))
        plain_ms = cuda_ms(lambda: blend_reference_variant(ops, w, variant), reps=5)
        extra = dict(wrapper_ms=wrapper_ms, frame_prepare_ms=cast_ms,
                     shift_windows_ms=rolls_ms, smooth_ms=smooth_ms,
                     peak_bytes_above_inputs=peak, shape=[B, Hp, Wp, n, w])
        log(f"{name}: {ms:.4f} ms on the random maps, {smooth_ms:.4f} ms on the "
            f"smooth ones")
        if variant == "lanephases":  # the design it was measured against
            extra["tma_ring_ms"] = ring = load_tool(RING_TOOL).ring_ms(
                ops, w, blend_reference_variant(ops, w, variant))
            log(f"{name}: the copy-engine ring of {RING_TOOL} "
                f"{ring:.4f} ms on the random maps, bit-equal")
        if variant == "phases":  # no phase table
            check(peak < PHASES_PEAK_BYTES,
                  f"{name} allocates {peak} bytes above its inputs")
        # each input read once, each output written once: the frame in the
        # type the kernel reads (bf16 rounds the float32 frame as it loads
        # it), four maps, the windows
        n_bytes = B * (Hp * Wp * (2 if variant in BF16_FRAME_VARIANTS else 4)
                       + n * 4 * 4 + n * w * w * 4)
        n_flops = B * n * w * w * 7
        n_bf16 = 0.0
        if variant == "mxu":  # two banded selection products a window:
            # per 16 rows and 16 columns of the padded tile, four products
            # of 16 x 16 by 16 x 8 for Wy @ block and three for (...) @ Wx
            Tp = -(-(w + 1) // 16) * 16
            n_bf16 = B * n * (Tp // 16) ** 2 * 7.0 * 2 * 16 * 16 * 8
        if name in EARLIER_MS:
            compare_with_earlier(name, {"pass2": dict(ms=ms, library_ms=library_ms)})
        rows.append(kernel_row(
            name, f"{name}.cu",
            f"torchpiv_tpu/experimental/shift_variants.py:{VARIANT_LINES[variant]}",
            max_err, ms, plain_ms, n_bytes, n_flops, library_ms,
            n_bf16_flops=n_bf16, **extra))
    log("shift wrappers at pass 2 (pad, split, frame, kernel): " + ", ".join(
        f"{v} {t:.4f} ms, {pk} B above its inputs" for v, (t, pk) in wrappers.items()))
    # the two wrappers differ only in their kernel: timed in turns, five
    # rounds each, and held to each other by their medians
    turns = {"rolls": [], "bf16": []}
    for _ in range(5):
        for v in turns:
            turns[v].append(queued_ms(
                lambda: shift_windows(frames, vx, vy, variant=v, **kw)))
    med = {v: statistics.median(t) for v, t in turns.items()}
    log("rolls and bf16 wrappers in turns: " + ", ".join(
        f"{v} {t!r} ms (median {med[v]:.4f})" for v, t in turns.items()))
    check(med["bf16"] <= med["rolls"] + MARGIN_MS,
          f"the bf16 wrapper ({med['bf16']} ms) is not within {MARGIN_MS} ms "
          f"of the rolls wrapper ({med['rolls']} ms)")
    return rows


def wrapper_time_and_peak(fn) -> tuple:
    """``(ms, bytes)``: ``fn``'s device time (``queued_ms``) and the most it
    allocates above what is held before it."""
    ms = queued_ms(fn)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return ms, torch.cuda.max_memory_allocated() - held


def def_grid(ops, w: int) -> torch.Tensor:
    """``grid_sample`` coordinates of every pixel of every deformed window
    (align_corners; the residual is not saturated: a yardstick only)."""
    B, Hp, Wp = ops.frame.shape
    dev = ops.frame.device
    n = torch.arange(ops.n_rows * ops.n_cols, device=dev)
    row0 = ((n // ops.n_cols) * ops.step + ops.off + ops.dy).float() + ops.fy
    col0 = ((n % ops.n_cols) * ops.step + ops.off + ops.dx).float() + ops.fx
    ar = torch.arange(w, device=dev, dtype=torch.float32)
    off = ar - (w - 1) / 2.0
    ioff, joff = off[:, None], off[None, :]
    e = (Ellipsis, None, None)
    ys = row0[e] + ar[:, None] + ops.gyi[e] * ioff + ops.gyj[e] * joff
    xs = col0[e] + ar[None, :] + ops.gxi[e] * ioff + ops.gxj[e] * joff
    gy = 2.0 * ys / (Hp - 1) - 1.0
    gx = 2.0 * xs / (Wp - 1) - 1.0
    return torch.stack([gx, gy], dim=-1).reshape(B, -1, w, 2)


def phase_def_kernel(frames: torch.Tensor) -> dict:
    """``def_windows`` against its plain version at the pass-2 shape, in both
    interpolations, bit for bit; timed on the random maps and on smooth
    ones."""
    from torchpiv_tpu_torch.kernels.deform import def_windows, launch
    from torchpiv_tpu_torch.kernels.shift import shift_windows
    from torchpiv_tpu_torch.ops.deform import def_operands, def_reference

    w, o, M = 32, 16, 2
    n = window_count(w, o)
    dev = frames.device
    g = torch.Generator(device="cpu").manual_seed(1)

    def maps(reach, slope, integer_block=0):
        vx = torch.rand(BATCH, n, generator=g) * 2 * reach - reach
        vy = torch.rand(BATCH, n, generator=g) * 2 * reach - reach
        grads = [(torch.rand(BATCH, n, generator=g) * 2 - 1) * slope for _ in range(4)]
        if integer_block:  # integer centres without gradient: tile copies
            vx[:, :integer_block] = vx[:, :integer_block].round()
            vy[:, :integer_block] = vy[:, :integer_block].round()
            for gr in grads:
                gr[:, :integer_block] = 0.0
        return [t.to(dev) for t in (vx, vy, *grads)]

    n_int = 2048
    cases = {
        # centres beyond the +-S = 16 px clamp, gradients in +-0.05 px/px,
        # the first 2048 windows with integer centres and no gradient
        "general": maps(24.0, 0.05, integer_block=n_int),
        # gradients of up to 0.6 px/px: +-9 px across the window, far past
        # the margin of 2, so most residuals sit at the clip bounds
        "saturating": maps(24.0, 0.6),
        # the main path's pass 2: smooth centres, the field's own gradient
        "smooth": [t.to(dev) for t in smooth_maps(w, o)]
        + [torch.full((BATCH, n), s, device=dev)
           for s in (SMOOTH_SLOPE, -SMOOTH_SLOPE, SMOOTH_SLOPE, SMOOTH_SLOPE)],
    }
    out = {}
    for interp in ("bilinear", "bicubic"):
        kw = dict(frame_shape=FRAME, wind_size=w, overlap=o, margin=M, interp=interp)
        max_err = 0.0
        for case, m in cases.items():
            got = def_windows(frames, *m, **kw)
            ops = def_operands(frames, *m, **kw)
            want = def_reference(ops, w)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            log(f"def_windows {interp} {case}: max |kernel - plain| = {err!r}")
            # explicitly rounded residual, weights and sums in the plain
            # version's order: nothing is allowed
            check(torch.equal(got, want), f"def_windows {interp} {case} must be bit-exact")
            if case == "general":
                check(torch.equal(got[:, :n_int], want[:, :n_int]),
                      "integer-centre zero-gradient windows must be bit-exact")
                # ... and equal the shift kernel's integer copy (away from
                # +S, where that kernel's narrower pad clamps its tile)
                vx, vy = m[0][:, :n_int], m[1][:, :n_int]
                copy = shift_windows(frames, m[0], m[1], frame_shape=FRAME,
                                     wind_size=w, overlap=o)[:, :n_int]
                inside = (vx < w // 2) & (vy < w // 2)
                check(torch.equal(got[:, :n_int][inside], copy[inside]),
                      f"def_windows {interp} integer windows != shift_windows")
                del copy
            del got, want
        m = cases["general"]
        ops = def_operands(frames, *m, **kw)
        ms = cuda_ms(lambda: launch(ops, w))
        smooth = def_operands(frames, *cases["smooth"], **kw)
        smooth_ms = cuda_ms(lambda: launch(smooth, w))
        log(f"def_windows {interp}: {ms:.4f} ms on the random maps, {smooth_ms:.4f} "
            f"ms on the smooth ones")
        del smooth
        wrapper_ms = cuda_ms(lambda: def_windows(frames, *m, **kw))
        plain_ms = cuda_ms(lambda: def_reference(ops, w), reps=3)
        library_ms = None
        if interp == "bilinear":
            grid = def_grid(ops, w)
            img = ops.frame[:, None]
            library_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
                img, grid, mode="bilinear", padding_mode="border",
                align_corners=True))
            del grid
        # bicubic has no library call: grid_sample's bicubic is a = -0.75
        B, Hp, Wp = ops.frame.shape
        n_bytes = B * (Hp * Wp * 4 + n * 8 * 4 + n * w * w * 4)
        # a pixel: two residuals (2 products, 2 sums, 2 clips each), two
        # floors, then bilinear: 4 hats of 3 and 4 taps of 3; bicubic: 8 Keys
        # weights of 12 and 16 taps of 3
        n_flops = B * n * w * w * (14 + (24 if interp == "bilinear" else 144))
        out[interp] = dict(max_err=max_err, ms=ms, plain_ms=plain_ms,
                           n_bytes=n_bytes, n_flops=n_flops,
                           library_ms=library_ms, wrapper_ms=wrapper_ms,
                           smooth_ms=smooth_ms, shape=[B, Hp, Wp, n, w, M])
    lin, cub = out["bilinear"], out["bicubic"]
    compare_with_earlier("def_windows", {"pass2": lin, "bicubic": cub})
    cub_bound, cub_by = roofline(cub["n_bytes"], cub["n_flops"])
    # one row: the bilinear numbers under the contract's keys (the DEF path
    # of this script runs bilinear), the bicubic ones beside them
    return kernel_row(
        "def_windows", "def_windows.cu", "torchpiv_tpu/kernels/def_pallas.py:73",
        max(lin["max_err"], cub["max_err"]), lin["ms"], lin["plain_ms"],
        lin["n_bytes"], lin["n_flops"], lin["library_ms"],
        wrapper_ms=lin["wrapper_ms"], smooth_ms=lin["smooth_ms"], shape=lin["shape"],
        bicubic={"ms": cub["ms"], "plain_ms": cub["plain_ms"],
                 "bound_ms": cub_bound, "bound_by": cub_by,
                 "library_ms": None, "wrapper_ms": cub["wrapper_ms"],
                 "smooth_ms": cub["smooth_ms"], "max_abs_err": cub["max_err"]})


def synthetic_maps(d: int, dev) -> torch.Tensor:
    """Constant maps and maps with their peak on every edge and corner (the
    flat-index neighbour wrap and clamp), and an exact tie."""
    g = torch.Generator(device="cpu").manual_seed(d)
    maps = torch.rand(11, d, d, generator=g) * 50.0
    maps[0] = 0.0
    maps[1] = 0.0
    for i, (r, c) in enumerate([(0, 0), (0, d - 1), (d - 1, 0), (d - 1, d - 1),
                                (0, 5), (d - 1, 7), (6, 0), (9, d - 1)], start=2):
        maps[i, r, c] = 200.0
    maps[10, 3, 4] = maps[10, 10, 12] = 150.0  # the first index wins
    # one pedestal pixel below all others, away from the peaks: no sample
    # that the fit reads lies within 2 of the map minimum, where the kernel's
    # (x - min) + EPS and the plain version's x + (EPS - min) differ (see
    # csrc/peakfit.cu)
    maps[2:, d // 2 + 3, d // 2 + 4] = -4.0
    return maps.to(dev)


def phase_peakfit_kernel(frames_a: torch.Tensor, frames_b: torch.Tensor) -> dict:
    """``peakfit`` against its plain version on the correlation maps of the
    two passes of the 4 MP path, with and without validation."""
    from torchpiv_tpu_torch.kernels.peakfit import launch, peakfit
    from torchpiv_tpu_torch.ops.correlate import correlate_fft
    from torchpiv_tpu_torch.ops.peakfit import correlation_to_displacement
    from torchpiv_tpu_torch.ops.windows import extract_windows

    dev = frames_a.device
    passes = {}
    max_err = 0.0
    for label, (w, o), dc in (("pass1", (64, 32), True), ("pass2", (32, 16), False)):
        aa = extract_windows(frames_a, w, o)
        bb = extract_windows(frames_b, w, o)
        real = correlate_fft(aa, bb, dc_normalize=dc).reshape(-1, w, w).contiguous()
        del aa, bb
        maps = torch.cat([real, synthetic_maps(w, dev)]).contiguous()
        for validate in (True, False):
            ku, kv, ki = peakfit(maps, validate, 1.2, 3, min_subtract=True)
            pu, pv, pi = correlation_to_displacement(maps, validate, 1.2, 3,
                                                     min_subtract=True)
            torch.cuda.synchronize()
            err = max((ku - pu).abs().max().item(), (kv - pv).abs().max().item())
            max_err = max(max_err, err)
            log(f"peakfit {label} {tuple(maps.shape)} validate={validate}: "
                f"max |kernel - plain| = {err!r} px")
            # logf, IEEE division and explicitly rounded sums: equality is
            # expected; allowed 1e-5 px; the masks must be equal
            check(err <= 1e-5, f"peakfit {label} u, v disagree by {err}")
            if validate:
                check(torch.equal(ki, pi), f"peakfit {label} masks differ")
                share = ki.float().mean().item()
                check(0.0 < share < 0.5, f"peakfit {label} invalid share {share}")
            else:
                check(ki is None and pi is None, "validate=False returns no mask")
        ms = cuda_ms(lambda: launch(real, True, 1.2, 3, True))
        plain_ms = cuda_ms(lambda: correlation_to_displacement(
            real, True, 1.2, 3, min_subtract=True), reps=5)
        n_maps = real.shape[0]
        n_bytes = n_maps * (w * w * 4 + 9)
        # a sample: minimum, compare and two selects for the first maximum,
        # maximum for the second peak (at w > 32 one more, the chunk's);
        # the exclusion test, about 12, on the 2 * 3 + 3 rows that can hold
        # the exclusion set (validation_window 3)
        n_flops = n_maps * (w * w * (5 if w <= 32 else 6) + 12 * 9 * w)
        bound_ms, bound_by = roofline(n_bytes, n_flops)
        passes[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, n_bytes=n_bytes, n_flops=n_flops,
                             shape=list(real.shape), library_ms=None)
        del real, maps
    compare_with_earlier("peakfit", passes)
    p2, p1 = passes["pass2"], passes["pass1"]
    # no single PyTorch call computes the fit: library_ms stays null
    return kernel_row(
        "peakfit", "peakfit.cu", "torchpiv_tpu/experimental/peakfit_pallas.py:34",
        max_err, p2["ms"], p2["plain_ms"], p2["n_bytes"], p2["n_flops"], None,
        shape=p2["shape"],
        pass1={k: p1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")})


def fft_flops(w: int) -> float:
    """The least operations of one window pair's correlation: two forward
    and one inverse real 2-D FFT (each half a complex one of ``5 n log2 n``,
    ``n = w * w``) and the spectrum product (6 a sample, half a spectrum)."""
    n = w * w
    return 3 * 0.5 * 5 * n * np.log2(n) + 3 * n


def fit_agreement(got, want, label: str) -> float:
    """Hold a pass-fusion kernel's ``(u, v, invalid)`` against its plain
    version's.  The two run different float32 FFTs, so the tolerance is:
    masks differ on at most 0.1% of the windows, the integer peak is the
    same on at least 99.9% of the jointly valid ones, and there ``u, v``
    agree within RMS 1e-4 px and 1e-3 px at most.  Returns the largest
    difference."""
    (ku, kv, ki), (pu, pv, pi) = got, want
    flips = (ki != pi).float().mean().item()
    both = ~(ki | pi)
    du, dv = (ku - pu)[both], (kv - pv)[both]
    same = (du.abs() < 0.5) & (dv.abs() < 0.5)
    moved = 1.0 - same.float().mean().item()
    d = torch.cat([du[same], dv[same]])
    rms = d.square().mean().sqrt().item()
    worst = d.abs().max().item()
    log(f"{label}: {ku.numel()} windows, invalid share {ki.float().mean().item():.4f}, "
        f"mask mismatch {flips:.6f}, other peak cell {moved:.6f}, RMS {rms:.3e} px, "
        f"largest {worst:.3e} px")
    check(flips <= 1e-3, f"{label}: masks differ on {flips} of the windows")
    check(moved <= 1e-3, f"{label}: another peak cell on {moved} of the windows")
    check(rms < 1e-4 and worst < 1e-3, f"{label}: RMS {rms}, largest {worst} px")
    return worst


def compare_with_earlier(name: str, passes: dict) -> None:
    """Print this run's times of a redesigned kernel beside the earlier
    design's (and its target, where it has one), and hold it to what the
    redesign was for: faster than the earlier design by more than
    ``MARGIN_MS`` at every shape it was read at, and, where the kernel has a
    yardstick (``library_ms`` not None), at pass 2 at most
    ``YARDSTICK_SHARE`` of it (the unfused chain; a shift or a deformation:
    no slower than ``grid_sample``).  The bicubic shift has none:
    ``grid_sample``'s bicubic is a = -0.75, not Keys' -0.5."""
    for label, was in EARLIER_MS[name].items():
        p = passes[label]
        target = TARGET_MS.get(name, {}).get(label)
        yard = p.get("library_ms")
        log(f"{name} {label}: {p['ms']:.4f} ms now, {was} ms before the redesign"
            + (f"; target {target} ms, {'met' if p['ms'] <= target else 'MISSED'}"
               if target is not None else "")
            + (f"; yardstick {yard:.4f} ms, ratio {p['ms'] / yard:.3f}" if yard else ""))
        check(p["ms"] < was - MARGIN_MS,
              f"{name} {label}: {p['ms']} ms is not {MARGIN_MS} ms faster than {was}")
    p2 = passes["pass2"]
    if p2.get("library_ms") is not None:
        check(p2["ms"] <= YARDSTICK_SHARE.get(name, 1.0) * p2["library_ms"],
              f"{name}: {p2['ms']} ms against {p2['library_ms']} ms of its yardstick")


def pass2_shifts(n: int, g, S: int = 16):
    """Per-window shifts of the two frames for a CWS-like pass 2: a common
    offset in +-(S - 2) px, so the tiles reach the clamp and the pad, with
    -+ half the displacement on top; a quarter of the windows integer-valued
    (the DWS tile copy)."""
    common_x = torch.rand(BATCH, n, generator=g) * 2 * (S - 2) - (S - 2)
    common_y = torch.rand(BATCH, n, generator=g) * 2 * (S - 2) - (S - 2)
    hx = torch.full((BATCH, n), DISPLACEMENT[0] / 2)
    hy = torch.full((BATCH, n), DISPLACEMENT[1] / 2)
    q = n // 4
    for t in (common_x, common_y, hx, hy):
        t[:, :q] = t[:, :q].round()
    return common_x - hx, common_y - hy, common_x + hx, common_y + hy


def phase_corrfit_kernel(frames_a: torch.Tensor, frames_b: torch.Tensor) -> dict:
    """``correlate_peakfit`` against its plain version at the two pass
    shapes of the 4 MP path; the unfused chain (``correlate_fft`` and the
    ``peakfit`` kernel) as the yardstick."""
    from torchpiv_tpu_torch.kernels import peakfit as peakfit_kernel
    from torchpiv_tpu_torch.kernels.corrfit import correlate_peakfit, launch
    from torchpiv_tpu_torch.kernels.shift import shift_windows
    from torchpiv_tpu_torch.ops.corrfit import correlate_peakfit_reference
    from torchpiv_tpu_torch.ops.correlate import correlate_fft
    from torchpiv_tpu_torch.ops.windows import extract_windows

    dev = frames_a.device
    passes = {}
    max_err = 0.0
    for label, (w, o), dc in FUSED_SHAPES:
        if dc:
            aa = extract_windows(frames_a, w, o)
            bb = extract_windows(frames_b, w, o)
        else:
            g = torch.Generator(device="cpu").manual_seed(2)
            vxa, vya, vxb, vyb = (t.to(dev) for t in pass2_shifts(
                window_count(w, o), g, S=w // 2))
            kw = dict(frame_shape=FRAME, wind_size=w, overlap=o)
            aa = shift_windows(frames_a, vxa, vya, **kw)
            bb = shift_windows(frames_b, vxb, vyb, **kw)
        aa = aa.reshape(-1, w, w).contiguous()
        bb = bb.reshape(-1, w, w).contiguous()
        got = correlate_peakfit(aa, bb, True, 1.2, 3, dc)
        want = correlate_peakfit_reference(aa, bb, True, 1.2, 3, dc)
        torch.cuda.synchronize()
        max_err = max(max_err, fit_agreement(
            got, want, f"correlate_peakfit {label} {tuple(aa.shape)}"))
        nu, nv, ni = correlate_peakfit(aa, bb, False, 1.2, 3, dc)
        check(ni is None and torch.equal(nu, got[0]) and torch.equal(nv, got[1]),
              "validate=False must return the same u, v and no mask")
        ms = cuda_ms(lambda: launch(aa, bb, True, 1.2, 3, dc))
        plain_ms = cuda_ms(lambda: correlate_peakfit_reference(aa, bb, True, 1.2, 3, dc),
                           reps=3)
        chain_ms = cuda_ms(lambda: peakfit_kernel.launch(
            correlate_fft(aa, bb, dc_normalize=dc), True, 1.2, 3, True))
        n = aa.shape[0]
        n_bytes = n * (2 * w * w * 4 + 9)
        n_flops = n * (fft_flops(w) + 15 * w * w)  # the fit: 15 a sample
        bound_ms, bound_by = roofline(n_bytes, n_flops)
        passes[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=chain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, n_bytes=n_bytes,
                             n_flops=n_flops, shape=list(aa.shape))
        del aa, bb, got, want
    p2 = passes["pass2"]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape")
    compare_with_earlier("correlate_peakfit", passes)
    return kernel_row(
        "correlate_peakfit", "corrfit.cu",
        "torchpiv_tpu/experimental/fused_pass.py:483",
        max_err, p2["ms"], p2["plain_ms"], p2["n_bytes"], p2["n_flops"],
        p2["library_ms"], library="correlate_fft + peakfit kernel (the unfused chain)",
        shape=p2["shape"],
        **{label: {k: p[k] for k in keys} for label, p in passes.items()
           if label != "pass2"})


def phase_fused_kernel(frames_a: torch.Tensor, frames_b: torch.Tensor) -> dict:
    """``fused_piv_pass`` against its plain version at the two pass shapes;
    two ``shift_windows`` launches and the unfused chain as the yardstick."""
    from torchpiv_tpu_torch.kernels import peakfit as peakfit_kernel
    from torchpiv_tpu_torch.kernels.corrfit import correlate_peakfit
    from torchpiv_tpu_torch.kernels.fused_pass import fused_piv_pass, launch
    from torchpiv_tpu_torch.kernels.shift import launch as shift_launch
    from torchpiv_tpu_torch.kernels.shift import shift_windows
    from torchpiv_tpu_torch.ops.corrfit import fused_pass_reference
    from torchpiv_tpu_torch.ops.correlate import correlate_fft
    from torchpiv_tpu_torch.ops.shifts import shift_operands

    dev = frames_a.device
    passes = {}
    max_err = 0.0
    for label, (w, o), dc in FUSED_SHAPES:
        n = window_count(w, o)
        if dc:  # the first pass: zero shifts
            maps = [torch.zeros(BATCH, n, device=dev)] * 4
        else:
            g = torch.Generator(device="cpu").manual_seed(3)
            maps = [t.to(dev) for t in pass2_shifts(n, g, S=w // 2)]
        kw = dict(frame_shape=FRAME, wind_size=w, overlap=o)
        got = fused_piv_pass(frames_a, frames_b, *maps, dc_normalize=dc, **kw)
        want = fused_pass_reference(frames_a, frames_b, *maps, dc_normalize=dc, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, fit_agreement(
            got, want, f"fused_piv_pass {label} {tuple(maps[0].shape)} w{w}"))
        del want
        # the kernel shifts with shift_windows' code and fits with
        # correlate_peakfit's: the same fields bit for bit, integer and
        # fractional shifts alike
        aa = shift_windows(frames_a, maps[0], maps[1], **kw)
        bb = shift_windows(frames_b, maps[2], maps[3], **kw)
        split = correlate_peakfit(aa.reshape(-1, w, w), bb.reshape(-1, w, w),
                                  True, 1.2, 3, dc)
        check(all(torch.equal(a.reshape(-1), b) for a, b in zip(got, split)),
              f"fused_piv_pass {label} != correlate_peakfit of shift_windows")
        del aa, bb, split, got
        ops_a = shift_operands(frames_a, maps[0], maps[1], **kw)
        ops_b = shift_operands(frames_b, maps[2], maps[3], **kw)
        ms = cuda_ms(lambda: launch(ops_a, ops_b, w, True, 1.2, 3, dc))
        wrapper_ms = cuda_ms(lambda: fused_piv_pass(
            frames_a, frames_b, *maps, dc_normalize=dc, **kw))
        plain_ms = cuda_ms(lambda: fused_pass_reference(
            frames_a, frames_b, *maps, dc_normalize=dc, **kw), reps=3)
        chain_ms = cuda_ms(lambda: peakfit_kernel.launch(
            correlate_fft(shift_launch(ops_a, w), shift_launch(ops_b, w),
                          dc_normalize=dc).reshape(-1, w, w), True, 1.2, 3, True))
        B, Hp, Wp = ops_a.frame.shape
        n_bytes = B * (2 * Hp * Wp * 4 + n * (8 * 4 + 9))
        # per window: two blends of 7 a pixel, the correlation, the fit
        n_flops = B * n * (2 * 7 * w * w + fft_flops(w) + 15 * w * w)
        bound_ms, bound_by = roofline(n_bytes, n_flops)
        passes[label] = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                             library_ms=chain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, n_bytes=n_bytes, n_flops=n_flops,
                             shape=[B, Hp, Wp, n, w])
    p2 = passes["pass2"]
    keys = ("ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "shape")
    compare_with_earlier("fused_piv_pass", passes)
    return kernel_row(
        "fused_piv_pass", "fused_pass.cu",
        "torchpiv_tpu/experimental/fused_pass.py:293",
        max_err, p2["ms"], p2["plain_ms"], p2["n_bytes"], p2["n_flops"],
        p2["library_ms"],
        library="2 shift_windows launches + correlate_fft + peakfit kernel",
        wrapper_ms=p2["wrapper_ms"], shape=p2["shape"],
        **{label: {k: p[k] for k in keys} for label, p in passes.items()
           if label != "pass2"})


def phase_packed_shift(frames: torch.Tensor) -> None:
    """``shift_windows(packed=True)`` against the repacked standard output
    at the pass-2 shape (127 columns: a tail of one window)."""
    from torchpiv_tpu_torch.kernels.shift import launch, shift_windows
    from torchpiv_tpu_torch.ops.packing import pack_windows
    from torchpiv_tpu_torch.ops.shifts import shift_operands

    w, o = 32, 16
    n_side = (FRAME[0] - w) // (w - o) + 1
    g = torch.Generator(device="cpu").manual_seed(4)
    kw = dict(frame_shape=FRAME, wind_size=w, overlap=o)
    cases = shift_cases(n_side * n_side, g)
    for case, (vx, vy) in cases.items():
        vx, vy = vx.to(frames.device), vy.to(frames.device)
        got = shift_windows(frames, vx, vy, packed=True, **kw)
        want = pack_windows(shift_windows(frames, vx, vy, **kw), n_side, n_side, w)
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"packed shift_windows {case} != pack_windows of the standard output")
        del got, want
    ops = shift_operands(frames, vx, vy, **kw)
    ms = cuda_ms(lambda: launch(ops, w, packed=True))
    std_ms = cuda_ms(lambda: launch(ops, w))
    log(f"shift_windows packed: bit-exact in {len(cases)} cases; "
        f"{ms:.4f} ms per launch packed, {std_ms:.4f} ms standard")


STORE_TYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def phase_store_types(frames: torch.Tensor, rows: list) -> None:
    """The narrow window stores (``out_dtype`` bfloat16 and float16) of rows
    1-3 at the pass-2 shape: the bilinear shift (standard and packed), the
    bicubic shift and the deformation (both interpolations), each
    ``torch.equal`` to its plain version's float32 result cast with
    ``.to()``, timed over 20 launches beside its float32 store, the bound
    recomputed for the narrower store.  Adds ``stores`` to the rows of
    ``shift_windows``, ``shift_windows_bicubic`` and ``def_windows``."""
    from torchpiv_tpu_torch.kernels import deform, shift
    from torchpiv_tpu_torch.ops.deform import def_operands, def_reference
    from torchpiv_tpu_torch.ops.packing import pack_windows, packed_width
    from torchpiv_tpu_torch.ops.shifts import (blend_reference, blend_reference_bicubic,
                                               shift_operands)

    w, o, M = 32, 16, 2
    n = window_count(w, o)
    n_side = (FRAME[0] - w) // (w - o) + 1
    dev = frames.device
    g = torch.Generator(device="cpu").manual_seed(6)
    vx, vy = ((torch.rand(BATCH, n, generator=g) * 48 - 24).to(dev) for _ in range(2))
    grads = [((torch.rand(BATCH, n, generator=g) * 2 - 1) * 0.05).to(dev) for _ in range(4)]
    kw = dict(frame_shape=FRAME, wind_size=w, overlap=o)
    cases = []  # (row, key, launch(dtype), plain(), maps, windows, flops a pixel)
    for interp, plain, name in (("bilinear", blend_reference, "shift_windows"),
                                ("bicubic", blend_reference_bicubic,
                                 "shift_windows_bicubic")):
        ops = shift_operands(frames, vx, vy, interp=interp, **kw)
        cases.append((name, "standard",
                      lambda dt, ops=ops, interp=interp: shift.launch(ops, w, interp,
                                                                      out_dtype=dt),
                      lambda ops=ops, plain=plain: plain(ops, w), ops, 4, n * w * w,
                      7 if interp == "bilinear" else 40))
        if interp == "bilinear":
            cases.append(("shift_windows", "packed",
                          lambda dt, ops=ops: shift.launch(ops, w, packed=True, out_dtype=dt),
                          lambda ops=ops: pack_windows(blend_reference(ops, w), n_side,
                                                       n_side, w),
                          ops, 4, n_side * w * packed_width(n_side, w), 7))
    for interp in ("bilinear", "bicubic"):
        ops = def_operands(frames, vx, vy, *grads, margin=M, interp=interp, **kw)
        cases.append(("def_windows", interp,
                      lambda dt, ops=ops: deform.launch(ops, w, dt),
                      lambda ops=ops: def_reference(ops, w), ops, 8, n * w * w,
                      14 + (24 if interp == "bilinear" else 144)))
    by_row = {r["name"]: r for r in rows}
    for name, key, launch, plain, ops, n_maps, n_out, flops in cases:
        want = plain()
        B, Hp, Wp = ops.frame.shape
        timed = {}
        for label, dt in (("float32", torch.float32), *STORE_TYPES.items()):
            got = launch(dt)
            torch.cuda.synchronize()
            check(got.dtype == dt and torch.equal(got, want.to(dt)),
                  f"{name} {key} {label} stores differ from the plain version's")
            del got
            size = torch.finfo(dt).bits // 8
            bound, by = roofline(B * (Hp * Wp * 4 + n * n_maps * 4 + n_out * size),
                                 B * n * w * w * flops)
            timed[label] = {"ms": cuda_ms(lambda: launch(dt)), "bound_ms": bound,
                            "bound_by": by}
        del want
        log(f"{name} {key} stores: " + ", ".join(
            f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, {v['bound_by']})"
            for k, v in timed.items()) + "; the narrow stores bit-equal to the plain "
            "version cast with .to()")
        by_row[name].setdefault("stores", {})[key] = timed


def load_tool(path: str):
    """The module of the tool at ``path`` (relative to this script)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0],
        os.path.join(os.path.dirname(os.path.abspath(__file__)), path))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def phase_shift_anatomy(frames: torch.Tensor) -> dict:
    """``tools/shift_anatomy_cuda.py``'s six modes of ``shift_windows`` at
    pass 2; returns the kernels line's row of its ``full`` mode (the
    counterpart of ``make_kernel``), with the launches of the tool's run."""
    from torchpiv_tpu_torch.ops.shifts import blend_reference

    tool = load_tool(ANATOMY)
    ops = tool.operands(frames)
    modes = {r["mode"]: r for r in tool.measure(ops)}
    for mode in tool.EXACT:
        check(modes[mode]["bit_equal"], f"anatomy {mode} is not bit-equal")
    full = modes["full"]
    plain_ms = cuda_ms(lambda: blend_reference(ops, tool.W), reps=5)
    grid = shift_grid(ops, tool.W)
    img = ops.frame[:, None]
    library_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        img, grid, mode="bilinear", padding_mode="border", align_corners=True))
    del grid, img
    B, Hp, Wp = ops.frame.shape
    n = ops.n_rows * ops.n_cols
    w = tool.W
    row = kernel_row(
        ANATOMY_ROW, "", "tools/bench_shift_anatomy.py:47",
        max(modes[m]["max_abs_err"] for m in tool.EXACT), full["ms"], plain_ms,
        B * (Hp * Wp * 4 + n * 4 * 4 + n * w * w * 4), B * n * w * w * 7, library_ms,
        shape=[B, Hp, Wp, n, w],
        modes={m: {k: r[k] for k in r if k != "mode"} for m, r in modes.items()})
    row["source"] = ANATOMY
    row["launches"] = full["launches"]
    return row


def phase_kernels(folder: str) -> list:
    """Every kernel against its plain version; returns the kernels' rows."""
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    _, a, b = PIVDataset(folder, ".bmp").read_batch(list(range(BATCH)))
    frames_a = torch.from_numpy(a).cuda().float()
    frames_b = torch.from_numpy(b).cuda().float()
    rows = phase_shift_kernels(frames_a)
    rows += phase_shift_variants(frames_a)
    rows.append(phase_def_kernel(frames_a))
    rows.append(phase_peakfit_kernel(frames_a, frames_b))
    rows.append(phase_corrfit_kernel(frames_a, frames_b))
    rows.append(phase_fused_kernel(frames_a, frames_b))
    phase_packed_shift(frames_a)
    phase_store_types(frames_a, rows)
    rows.append(phase_shift_anatomy(frames_a))
    torch.cuda.empty_cache()
    log("kernels of the port: " + ", ".join(r["name"] for r in rows))
    return rows


def write_pairs(folder: str, n: int, displacement, seed: int) -> None:
    from torchpiv_tpu_torch.io.decode import imwrite_gray
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    os.makedirs(folder)
    for i in range(n):
        fa, fb = particle_pair(FRAME, displacement, seed=seed + i)
        imwrite_gray(os.path.join(folder, f"p{i}_a.bmp"), fa)
        imwrite_gray(os.path.join(folder, f"p{i}_b.bmp"), fb)


def decoder_of(piv) -> str:
    """Which decoder ``piv``'s prefetcher runs: the native bulk decoder
    where the dataset has a native shape, else the per-file Python one."""
    if getattr(piv._dataset, "native_shape", None) is not None:
        from torchpiv_tpu_torch.native import loader

        return f"native ({loader.library_path().name})"
    return "python (per file" + (", preprocess)" if not hasattr(
        piv._dataset, "read_batch") else ")")


def drive(piv, kernels):
    """Drain ``piv()`` with every launch count set to 0 just before and read
    just after; returns ``(fields, launches, pairs_per_s)``."""
    ds = piv._dataset
    folder = getattr(ds, "folder", None) or ds.dataset.folder  # under a preprocess
    log(f"OfflinePIV over {os.path.basename(folder)}: decoder {decoder_of(piv)}")
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    fields = list(piv())
    elapsed = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    return fields, launches, len(fields) / elapsed


def span_report(label: str, spans: list, t0: float, wall_s: float) -> dict:
    """Log a run's host spans (``OfflinePIV.span_log``): per-batch medians
    and sums of each span, the busy share they give (device ms over the
    wall time) and the first field's latency; returns the summary."""
    keys = [k for k in SPANS if spans[0][k] is not None]  # h2d_ms: None on a mesh
    summary = {
        "spans": label, "batches": len(spans), "pairs": sum(s["pairs"] for s in spans),
        "wall_s": wall_s,
        "median": {k: float(np.median([s[k] for s in spans])) for k in keys},
        "sum": {k: float(sum(s[k] for s in spans)) for k in keys},
        "busy_share_spans": sum(s["device_ms"] for s in spans) / 1e3 / wall_s,
        "first_field_s": spans[0]["first_field_t"] - t0}
    log(json.dumps(summary))
    return summary


def drive_with_spans(piv, kernels, label: str):
    """``drive`` with ``piv.span_log`` on; returns ``(fields, launches,
    pairs_per_s, span summary)``."""
    piv.span_log = []
    t0 = time.perf_counter()
    fields, launches, pairs_per_s = drive(piv, kernels)
    summary = span_report(label, piv.span_log, t0, len(fields) / pairs_per_s)
    piv.span_log = None
    return fields, launches, pairs_per_s, summary


def warm_up(piv, folder: str) -> float:
    """One engine call on the first batch (cuFFT plans, the caching
    allocator); returns its valid share."""
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    _, a, b = PIVDataset(folder, ".bmp").read_batch(list(range(BATCH)))
    _, _, inval = piv.engine(torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda())
    return 1.0 - inval.float().mean().item()


def check_fields(fields, piv, n_pairs: int) -> None:
    check(len(fields) == n_pairs, f"{len(fields)} of {n_pairs} pairs came out")
    shape = piv.engine.final_field_shape
    for _, _, u, v in fields:
        check(u.shape == v.shape == shape, f"field shape {u.shape}")
        check(np.isfinite(u).all() and np.isfinite(v).all(), "non-finite field")


UNIT = 1000.0  # px -> output units: scale / dt * 1000, defaults 1 and 1


def phase_main_path(folder: str, kernels):
    """OfflinePIV at 4 MP, w64/o32, 2-pass CWS; returns the launch counts,
    pairs/s, the fields and the span summary."""
    from torchpiv_tpu_torch import OfflinePIV

    piv = OfflinePIV(folder, wind_size=64, overlap=32, multipass=2,
                     multipass_mode="CWS", batch_size=BATCH)
    valid = warm_up(piv, folder)
    log(f"CWS path: valid share {valid:.4f} over the first {BATCH} pairs")
    check(valid > 0.95, f"valid share {valid}")

    fields, launches, pairs_per_s, spans = drive_with_spans(piv, kernels, "CWS path")
    log(f"CWS path: {len(fields)} pairs at {pairs_per_s:.3f} pairs/s, "
        f"launches {launches}")
    check_fields(fields, piv, N_PAIRS)
    n_batches = -(-N_PAIRS // BATCH)
    check(launches == only(launches, shift_windows=2 * n_batches),
          f"launches {launches}")
    check_displacement(fields, "CWS path")
    return launches, pairs_per_s, fields, spans


def only(launches: dict, **counts) -> dict:
    """The expected launch counts: ``counts``, and 0 for every other kernel."""
    return {**dict.fromkeys(launches, 0), **counts}


def check_displacement(fields, label: str, tol: float = 0.05) -> None:
    for _, _, u, v in fields:
        mu = u[2:-2, 2:-2].mean() / UNIT
        mv = -v[2:-2, 2:-2].mean() / UNIT  # the y axis is flipped
        check(abs(mu - DISPLACEMENT[0]) < tol, f"{label}: mean u {mu}")
        check(abs(mv - DISPLACEMENT[1]) < tol, f"{label}: mean v {mv}")
    log(f"{label}: interior mean displacement of the last pair "
        f"({mu:.4f}, {mv:.4f}) px, expected {DISPLACEMENT}")


def shear_error(fields, piv) -> float:
    """The worst pair's interior mean |u - shear| in px."""
    _, y = piv.engine.final_coordinates
    want = SHEAR[0] + SHEAR[1] * y[2:-2, 2:-2]
    return max(float(np.abs(np.flip(u, axis=0)[2:-2, 2:-2] / UNIT - want).mean())
               for _, _, u, _ in fields)


def phase_fused_paths(uniform: str, shear: str, kernels) -> dict:
    """OfflinePIV at 4 MP, w64/o32, 2-pass CWS over the uniform pairs with
    ``fused="split"`` and with ``fused="on"``, then one batch of
    ``fused="split"`` + DEF over the sheared pairs; returns
    ``{mode: (launches, pairs_per_s, fields, span summary)}`` of the two CWS
    runs."""
    from torchpiv_tpu_torch import OfflinePIV

    kw = dict(wind_size=64, overlap=32, multipass=2, batch_size=BATCH)
    n_batches = -(-N_PAIRS // BATCH)
    out = {}
    for fused, want in (
            # per batch: one correlate-and-fit launch a pass and one shift
            # launch a frame, or one whole-pass launch a pass
            ("split", dict(correlate_peakfit=2 * n_batches,
                           shift_windows=2 * n_batches)),
            ("on", dict(fused_piv_pass=2 * n_batches))):
        label = f"CWS path fused={fused}"
        piv = OfflinePIV(uniform, multipass_mode="CWS",
                         engine_options={"fused": fused}, **kw)
        check(piv.engine.device.type == "cuda" and piv.engine.config.fused == fused,
              f"{label}: the knob did not reach an engine on the card")
        valid = warm_up(piv, uniform)
        log(f"{label}: valid share {valid:.4f} over the first {BATCH} pairs")
        check(valid > 0.95, f"{label}: valid share {valid}")
        fields, launches, pairs_per_s, spans = drive_with_spans(piv, kernels, label)
        log(f"{label}: {len(fields)} pairs at {pairs_per_s:.3f} pairs/s, "
            f"launches {launches}")
        check_fields(fields, piv, N_PAIRS)
        check(launches == only(launches, **want), f"{label}: launches {launches}")
        check_displacement(fields, label)
        out[fused] = (launches, pairs_per_s, fields, spans)

    piv = OfflinePIV(shear, multipass_mode="DEF", max_pairs=BATCH,
                     engine_options={"fused": "split"}, **kw)
    fields, launches, _ = drive(piv, kernels)
    check_fields(fields, piv, BATCH)
    check(launches == only(launches, def_windows=2, correlate_peakfit=2),
          f"DEF fused=split launches {launches}")
    mae = shear_error(fields, piv)
    log(f"DEF fused=split: one batch, launches {launches}, "
        f"worst mean |u - shear| {mae:.4f} px")
    check(mae < 0.1, f"DEF fused=split shear error {mae}")
    return out


def same_fields(got, want, label: str) -> None:
    """Two runs' output fields, equal to the last bit."""
    check(len(got) <= len(want), f"{label}: {len(got)} fields against {len(want)}")
    for a, b in zip(got, want):
        check(all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"{label}: the fields differ from the run they are held against")


def link_pairs(src: str, dst: str, n: int) -> None:
    """``n`` pairs in ``dst`` that are hard links to the ``N_PAIRS`` pairs
    of ``src`` in turn: every pair is decoded, from the page cache."""
    os.makedirs(dst)
    for j in range(n):
        for tag in "ab":
            os.link(os.path.join(src, f"p{j % N_PAIRS}_{tag}.bmp"),
                    os.path.join(dst, f"p{j}_{tag}.bmp"))


def serial_yardstick(piv, issue_log=None) -> list:
    """The loop the port's ``OfflinePIV`` ran before its three stages, on
    ``piv``'s dataset and engine: prefetch, ``packed_forward``, a
    synchronous ``.cpu().numpy()`` on the calling thread, then the host
    tail of that batch on a pool while the next batch is issued.  With
    ``issue_log`` (a list) each batch appends the seconds of its
    ``packed_forward`` call on the host clock."""
    from concurrent.futures import ThreadPoolExecutor

    from torchpiv_tpu_torch.io.prefetch import PairPrefetcher
    from torchpiv_tpu_torch.pipeline import finalize_fields, packed_forward

    engine = piv.engine
    x, y = engine.final_coordinates
    tail_validates = engine.config.validate and engine.config.infill == "host"
    static = engine.window_masked[-1]
    static = None if static is None else static.cpu().numpy()

    def tail(ids, packed):
        return [finalize_fields(packed[i, 0], packed[i, 1],
                                packed[i, 2] > 0.5 if tail_validates else None,
                                x, y, piv._scale, piv._dt, static)
                for i in range(len(ids))]

    out = []
    prefetch = PairPrefetcher(piv._dataset, piv._batch, engine.device,
                              num_threads=piv._decode_threads, depth=2)
    with ThreadPoolExecutor(max_workers=max(1, piv._decode_threads)) as pool:
        pending = None
        for a, b, ids in prefetch:
            t0 = time.perf_counter()
            packed = packed_forward(engine, a, b)
            if issue_log is not None:
                issue_log.append(time.perf_counter() - t0)
            packed = packed.cpu().numpy()
            done, pending = pending, pool.submit(tail, ids, packed)
            if done is not None:
                out += [r for r in done.result() if r is not None]
        if pending is not None:
            out += [r for r in pending.result() if r is not None]
    return out


def phase_serial_against_pipelined(folder: str) -> dict:
    """``serial_yardstick`` against ``OfflinePIV()`` in turns (serial,
    pipelined, pipelined, serial) over the ``N_LINKED`` linked pairs, one
    instance and so one engine, for CWS unfused and ``fused="on"``; the
    pipelined fields must equal the serial ones bit for bit.  Then one more
    pipelined run with its spans.  Both are run once untimed first, so
    that each starts with the caching allocator warm on its streams.
    Returns ``{label: pairs/s by kind}``; speed is reported, not checked."""
    from torchpiv_tpu_torch import OfflinePIV

    out = {}
    for label, options in (("CWS", {}), ("CWS fused=on", {"fused": "on"})):
        piv = OfflinePIV(folder, wind_size=64, overlap=32, multipass=2,
                         batch_size=BATCH, engine_options=options)
        serial_yardstick(piv)
        list(piv())
        rates = {"serial": [], "pipelined": []}
        runs = {}
        issue = []  # the serial runs' packed_forward calls
        for kind in ("serial", "pipelined", "pipelined", "serial"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fields = serial_yardstick(piv, issue) if kind == "serial" else list(piv())
            rates[kind].append(len(fields) / (time.perf_counter() - t0))
            check(len(fields) == N_LINKED, f"{label} {kind}: {len(fields)} fields")
            if kind in runs:
                same_fields(fields, runs[kind], f"{label} {kind}, second run")
            else:
                runs[kind] = fields
        same_fields(runs["pipelined"], runs["serial"], f"{label}: pipelined against serial")
        out[label] = {kind: {"median": float(np.median(r)), "spread": max(r) - min(r),
                             "runs": r} for kind, r in rates.items()}
        out[label]["serial"]["issue_ms_median"] = float(np.median(issue)) * 1e3
        log(json.dumps({"turns": label, "pairs": N_LINKED, "pairs_per_s": out[label]}))
        log(f"{label}: {N_LINKED} linked pairs, serial {out[label]['serial']['median']:.3f} "
            f"pairs/s (spread {out[label]['serial']['spread']:.3f}), pipelined "
            f"{out[label]['pipelined']['median']:.3f} (spread "
            f"{out[label]['pipelined']['spread']:.3f}); fields bit-equal; serial "
            f"issue {out[label]['serial']['issue_ms_median']:.3f} ms a batch (median)")
        del runs
        piv.span_log = []
        t0 = time.perf_counter()
        n = len(list(piv()))
        span_report(f"{label}, {N_LINKED} linked pairs", piv.span_log, t0,
                    time.perf_counter() - t0)
        check(n == N_LINKED, f"{label}: {n} fields in the span run")
    return out


def phase_decoders(folder: str) -> dict:
    """The native bulk decoder against the per-file Python one over the
    ``N_LINKED`` linked pairs, in turns (native, Python, Python, native) on
    one ``OfflinePIV`` instance a configuration, CWS and ``fused="on"``, run
    once untimed first: the fields bit-equal, and each run's medians a
    batch of the decode span (``decode_s``) and of the feeder's issue of
    the engine (``issue_s``), host clock.  Returns ``{label: {decoder:
    {"decode_ms": [..], "issue_ms": [..]}}}``; speed is reported, not
    checked."""
    from torchpiv_tpu_torch import OfflinePIV

    out = {}
    for label, options in (("CWS", {}), ("CWS fused=on", {"fused": "on"})):
        piv = OfflinePIV(folder, wind_size=64, overlap=32, multipass=2,
                         batch_size=BATCH, engine_options=options)
        shape = piv._dataset.native_shape
        check(shape is not None, f"{label}: the native decoder does not take the pairs")
        want = list(piv())
        runs = {kind: {"decode_ms": [], "issue_ms": []} for kind in ("native", "python")}
        for kind in ("native", "python", "python", "native"):
            piv._dataset.native_shape = shape if kind == "native" else None
            piv.span_log = []
            fields = list(piv())
            check(len(fields) == N_LINKED, f"{label} {kind}: {len(fields)} fields")
            same_fields(fields, want, f"{label}: {kind} decode")
            for key, span in (("decode_ms", "decode_s"), ("issue_ms", "issue_s")):
                runs[kind][key].append(
                    float(np.median([b[span] for b in piv.span_log])) * 1e3)
        piv._dataset.native_shape = shape
        piv.span_log = None
        out[label] = runs
        log(json.dumps({"decoders": label, "pairs": N_LINKED, **runs}))
        med = {k: {m: float(np.median(v)) for m, v in r.items()} for k, r in runs.items()}
        log(f"{label}: decode {med['native']['decode_ms']:.1f} ms a batch of {BATCH} "
            f"pairs native, {med['python']['decode_ms']:.1f} Python; the feeder's issue "
            f"{med['native']['issue_ms']:.1f} / {med['python']['issue_ms']:.1f} ms a "
            f"batch (medians of two runs each); fields bit-equal")
    return out


def phase_background_preprocess(rough: str, uniform: str, tmp: str, kernels):
    """One batch of ``background="auto"`` over the rough pairs, equal bit for
    bit to an engine of the same configuration on frames whose background
    was subtracted on the host (the saturating uint8 subtract is exact), and
    one batch of ``preprocess="clahe"`` over the uniform pairs; returns the
    ``background="auto"`` fields."""
    from torchpiv_tpu_torch import OfflinePIV
    from torchpiv_tpu_torch.io.dataset import PIVDataset, compute_background
    from torchpiv_tpu_torch.io.decode import imwrite_gray

    kw = dict(wind_size=64, overlap=32, multipass=2, batch_size=BATCH, max_pairs=BATCH)
    piv = OfflinePIV(rough, background="auto", **kw)
    fields, launches, _ = drive(piv, kernels)
    check_fields(fields, piv, BATCH)
    check(launches == only(launches, shift_windows=2), f"background: launches {launches}")
    bg_fields = fields
    ds = PIVDataset(rough, ".bmp")
    ds.img_pairs = ds.img_pairs[:BATCH]
    bg = compute_background(ds)
    clean = os.path.join(tmp, "clean")
    os.makedirs(clean)
    for i in range(BATCH):
        for frame, tag in zip(ds[i], "ab"):
            imwrite_gray(os.path.join(clean, f"p{i}_{tag}.bmp"),
                         np.where(frame > bg, frame - bg, 0).astype(np.uint8))
    want = list(OfflinePIV(clean, **kw)())
    check(len(want) == BATCH, "cleaned frames: a pair is missing")
    same_fields(fields, want, "background=auto against frames cleaned on the host")
    log(f"background=auto: one batch of the rough pairs, background mean "
        f"{bg.mean():.3f} grey levels (max {int(bg.max())}), fields equal bit for bit "
        f"to frames cleaned on the host")

    piv = OfflinePIV(uniform, preprocess="clahe", **kw)
    fields, launches, _ = drive(piv, kernels)
    check_fields(fields, piv, BATCH)
    check(launches == only(launches, shift_windows=2), f"clahe: launches {launches}")
    check_displacement(fields, "preprocess=clahe (one batch)")
    pairs = [piv._dataset[i] for i in range(BATCH)]
    a = torch.from_numpy(np.stack([p[0] for p in pairs])).cuda()
    b = torch.from_numpy(np.stack([p[1] for p in pairs])).cuda()
    _, _, inval = piv.engine(a, b)
    valid = 1.0 - inval.float().mean().item()
    log(f"preprocess=clahe: valid share {valid:.4f} over the batch")
    check(valid > 0.95, f"preprocess=clahe: valid share {valid}")
    return bg_fields


def phase_variant_paths(folder: str, kernels, rolls_fields, split_fields) -> dict:
    """The shift-variant paths at 4 MP, w64/o32, 2-pass CWS over the uniform
    pairs: all pairs with ``shift_variant="bf16"``, one batch each with the
    other three variants and one with ``fused="split"`` + ``"bf16"``.  The
    frames are 8-bit, so every run's fields equal the ``rolls`` run's bit for
    bit.  Returns ``{variant: launches}`` and the bf16 run's pairs/s."""
    from torchpiv_tpu_torch import OfflinePIV

    kw = dict(wind_size=64, overlap=32, multipass=2, multipass_mode="CWS",
              batch_size=BATCH)
    n_batches = -(-N_PAIRS // BATCH)
    out = {}
    piv = OfflinePIV(folder, engine_options={"shift_variant": "bf16"}, **kw)
    check(piv.engine.device.type == "cuda" and piv.engine._shift_variant() == "bf16",
          "shift_variant did not reach an engine on the card")
    valid = warm_up(piv, folder)
    log(f"CWS path shift_variant=bf16: valid share {valid:.4f} over the first "
        f"{BATCH} pairs")
    check(valid > 0.95, f"shift_variant=bf16: valid share {valid}")
    fields, launches, pairs_per_s = drive(piv, kernels)
    log(f"CWS path shift_variant=bf16: {len(fields)} pairs at {pairs_per_s:.3f} "
        f"pairs/s, launches {launches}")
    check_fields(fields, piv, N_PAIRS)
    check(launches == only(launches, shift_windows_bf16=2 * n_batches),
          f"shift_variant=bf16: launches {launches}")
    check_displacement(fields, "CWS path shift_variant=bf16")
    same_fields(fields, rolls_fields, "shift_variant=bf16")
    out["bf16"] = launches
    out["pairs_per_s"] = pairs_per_s

    for variant in ("lanephases", "mxu", "phases"):
        piv = OfflinePIV(folder, max_pairs=BATCH,
                         engine_options={"shift_variant": variant}, **kw)
        fields, launches, _ = drive(piv, kernels)
        check_fields(fields, piv, BATCH)
        check(launches == only(launches, **{f"shift_windows_{variant}": 2}),
              f"shift_variant={variant}: launches {launches}")
        check_displacement(fields, f"CWS path shift_variant={variant} (one batch)")
        same_fields(fields, rolls_fields, f"shift_variant={variant}")
        log(f"shift_variant={variant}: one batch, launches {launches}, fields "
            f"equal the rolls run's bit for bit")
        out[variant] = launches

    piv = OfflinePIV(folder, max_pairs=BATCH,
                     engine_options={"shift_variant": "bf16", "fused": "split"}, **kw)
    fields, launches, _ = drive(piv, kernels)
    check_fields(fields, piv, BATCH)
    check(launches == only(launches, correlate_peakfit=2, shift_windows_bf16=2),
          f"fused=split + bf16: launches {launches}")
    same_fields(fields, split_fields, "fused=split + shift_variant=bf16")
    log(f"fused=split + shift_variant=bf16: one batch, launches {launches}, fields "
        f"equal the fused=split run's bit for bit")
    return out


def write_rough_pairs(src: str, dst: str, seed: int) -> None:
    """The uniform pairs with trouble written into the BMPs from ``seed``:
    ``N_PATCHES`` patches of uncorrelated noise in each second frame."""
    from torchpiv_tpu_torch.io.dataset import PIVDataset
    from torchpiv_tpu_torch.io.decode import imwrite_gray

    os.makedirs(dst)
    ds = PIVDataset(src, ".bmp")
    rng = np.random.default_rng(seed)
    for i in range(len(ds)):
        fa, fb = ds[i]
        fb = fb.copy()
        for _ in range(N_PATCHES):
            r = rng.integers(0, FRAME[0] - PATCH)
            c = rng.integers(WALL, FRAME[1] - PATCH)
            fb[r:r + PATCH, c:c + PATCH] = rng.integers(0, 256, (PATCH, PATCH))
        imwrite_gray(os.path.join(dst, f"p{i}_a.bmp"), fa)
        imwrite_gray(os.path.join(dst, f"p{i}_b.bmp"), fb)


def wall_mask() -> np.ndarray:
    """The robust path's region-of-interest mask: a wall along the left edge."""
    mask = np.zeros(FRAME, bool)
    mask[:, :WALL] = True
    return mask


def check_masked_fields(fields, piv, label: str, tol: float = 0.05) -> None:
    """Zero displacement in the masked windows, the synthetic displacement
    within ``tol`` px over the windows clear of the mask and the frame's edge."""
    masked = np.flip(piv.engine.window_masked[-1].cpu().numpy(), axis=0)
    check(masked.any() and not masked.all(), f"{label}: the mask masks {masked.mean()}")
    clear = ~masked
    clear[:2] = clear[-2:] = False
    clear[:, -2:] = False
    clear[:, :np.flatnonzero(~masked[0])[0] + 2] = False
    for _, _, u, v in fields:
        check((u[masked] == 0).all() and (v[masked] == 0).all(),
              f"{label}: a masked window moved")
        mu, mv = u[clear].mean() / UNIT, -v[clear].mean() / UNIT
        check(abs(mu - DISPLACEMENT[0]) < tol, f"{label}: mean u {mu}")
        check(abs(mv - DISPLACEMENT[1]) < tol, f"{label}: mean v {mv}")
    log(f"{label}: {int(masked.sum())} of {masked.size} windows masked and at zero; "
        f"mean displacement of the last pair outside ({mu:.4f}, {mv:.4f}) px")


def phase_robust_paths(folder: str, kernels) -> dict:
    """The robust configuration at 4 MP over 8 uniform pairs with corrupted
    patches and a wall mask: ``shift_variant="phases"``, the normalized-median
    filter, velocity limits, the global sigma test and the second-peak
    fallback; then one batch each of RPC + Gaussian window weights, the
    gauss2d fit and ``infill="fused"``.  Returns the first run's launch
    counts and pairs/s."""
    from torchpiv_tpu_torch import OfflinePIV
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    kw = dict(wind_size=64, overlap=32, multipass=2, multipass_mode="CWS",
              batch_size=BATCH)
    roi = {"frame_mask": wall_mask()}
    n_batches = -(-N_PAIRS // BATCH)
    piv = OfflinePIV(folder, engine_options={"shift_variant": "phases", **ROBUST, **roi},
                     **kw)
    cfg = piv.engine.config
    check(piv.engine.device.type == "cuda" and cfg.second_peak_fallback
          and cfg.median_filter == "normmedian" and piv.engine.frame_mask is not None,
          "the robust knobs did not reach an engine on the card")
    masked = piv.engine.window_masked[-1]
    _, a, b = PIVDataset(folder, ".bmp").read_batch(list(range(BATCH)))
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    _, _, inval = piv.engine(a, b)
    check(bool(inval[:, masked].all()), "a masked window is valid")
    valid = 1.0 - inval[:, ~masked].float().mean().item()
    plain = OfflinePIV(folder, engine_options={"shift_variant": "phases", **roi}, **kw)
    _, _, plain_inval = plain.engine(a, b)
    flagged = plain_inval[:, ~masked].float().mean().item()
    log(f"robust path: valid share outside the mask {valid:.4f} over the first "
        f"{BATCH} pairs ({1 - flagged:.4f} with the peak ratio alone)")
    check(flagged > 0.0, "the corrupted patches invalidate nothing")
    check(valid > 0.95, f"robust path: valid share {valid}")
    fields, launches, pairs_per_s = drive(piv, kernels)
    log(f"robust path: {len(fields)} pairs at {pairs_per_s:.3f} pairs/s, "
        f"launches {launches}")
    check_fields(fields, piv, N_PAIRS)
    check(launches == only(launches, shift_windows_phases=2 * n_batches),
          f"robust path: launches {launches}")
    check_masked_fields(fields, piv, "robust path")
    robust_launches = launches

    # the 3-point fit on the phase correlation's peak carries a bias of
    # about 0.05 px on these particle images (in the JAX engine too), so
    # that batch is held to 0.1 px
    for label, options, tol in (
            ("rpc + gaussian weights",
             {"correlation": "rpc", "window_weight": "gaussian"}, 0.1),
            ("gauss2d", {"subpixel": "gauss2d"}, 0.05),
            ("infill=fused", {"infill": "fused", **ROBUST}, 0.05)):
        one = OfflinePIV(folder, max_pairs=BATCH, engine_options={**options, **roi}, **kw)
        if options.get("infill") == "fused":
            u, v, inval = one.engine(a, b)
            check(bool(torch.isfinite(u).all() and torch.isfinite(v).all()),
                  "infill=fused left a NaN")
            check(bool(inval.any()), "infill=fused had nothing to fill")
        fields, launches, _ = drive(one, kernels)
        check_fields(fields, one, BATCH)
        check(launches == only(launches, shift_windows=2),
              f"{label}: launches {launches}")
        check_masked_fields(fields, one, f"robust path, {label} (one batch)", tol)
    return robust_launches, pairs_per_s


def phase_def_path(folder: str, kernels):
    """OfflinePIV at 4 MP, w64/o32, 2-pass DEF on sheared pairs with the fused
    peak fit; returns the launch counts and pairs/s.  The same run with the
    torch-op peak fit follows, for its pairs/s only."""
    from torchpiv_tpu_torch import OfflinePIV

    kw = dict(wind_size=64, overlap=32, multipass=2, multipass_mode="DEF",
              batch_size=BATCH)
    piv = OfflinePIV(folder, engine_options={"peakfit": "pallas"}, **kw)
    valid = warm_up(piv, folder)
    log(f"DEF path: valid share {valid:.4f} over the first {BATCH} pairs")
    check(valid > 0.95, f"valid share {valid}")

    fields, launches, pairs_per_s = drive(piv, kernels)
    log(f"DEF path (peakfit=pallas): {len(fields)} pairs at "
        f"{pairs_per_s:.3f} pairs/s, launches {launches}")
    check_fields(fields, piv, N_SHEAR_PAIRS)
    n_batches = -(-N_SHEAR_PAIRS // BATCH)
    check(launches == only(launches, def_windows=2 * n_batches,
                           peakfit=2 * n_batches), f"launches {launches}")
    _, y = piv.engine.final_coordinates
    want = SHEAR[0] + SHEAR[1] * y[2:-2, 2:-2]
    for _, _, u, v in fields:
        # the pipeline flips the fields to the physical y axis
        got = np.flip(u, axis=0)[2:-2, 2:-2] / UNIT
        mae = np.abs(got - want).mean()
        mv = v[2:-2, 2:-2].mean() / UNIT
        check(mae < 0.1, f"shear: mean |u - (1 + 0.004 y)| = {mae}")
        check(abs(mv) < 0.05, f"shear: mean v {mv}")
    log(f"DEF path: last pair mean |u - ({SHEAR[0]} + {SHEAR[1]} y)| = {mae:.4f} px "
        f"over u in [{want.min():.2f}, {want.max():.2f}] px, mean v {mv:.4f} px")

    xla = OfflinePIV(folder, engine_options={"peakfit": "xla"}, **kw)
    warm_up(xla, folder)
    xfields, xlaunches, xla_pairs_per_s = drive(xla, kernels)
    check_fields(xfields, xla, N_SHEAR_PAIRS)
    check(xlaunches["peakfit"] == 0 and xlaunches["def_windows"] == 2 * n_batches,
          f"launches {xlaunches}")
    worst = max(np.abs(a[2] - b[2]).max() for a, b in zip(fields, xfields)) / UNIT
    log(f"DEF path: {pairs_per_s:.3f} pairs/s with peakfit=pallas, "
        f"{xla_pairs_per_s:.3f} with peakfit=xla (one drained run each); "
        f"largest |u| difference between the two {worst:.2e} px")
    check(worst < 1e-3, f"the two peak fits differ by {worst} px")
    return launches, pairs_per_s


def phase_bicubic_paths(folder: str, kernels) -> dict:
    """One batch each of CWS + bicubic and DEF + bicubic through OfflinePIV;
    returns the CWS + bicubic launch counts."""
    from torchpiv_tpu_torch import OfflinePIV

    out = {}
    for mode, expect in (("CWS", "shift_windows_bicubic"), ("DEF", "def_windows")):
        piv = OfflinePIV(folder, wind_size=64, overlap=32, multipass=2,
                         multipass_mode=mode, batch_size=BATCH, max_pairs=BATCH,
                         engine_options={"cws_interp": "bicubic"})
        fields, launches, _ = drive(piv, kernels)
        check_fields(fields, piv, BATCH)
        check(launches == only(launches, **{expect: 2}),
              f"{mode} + bicubic launches {launches}")
        mae = shear_error(fields, piv)
        log(f"{mode} + bicubic: one batch, launches {launches}, "
            f"worst mean |u - shear| {mae:.4f} px")
        check(mae < 0.1, f"{mode} + bicubic shear error {mae}")
        out[mode] = launches
    return out["CWS"]


def phase_profile(folder: str, label: str, frame_mask=None, **cfg_kw) -> dict:
    """Engine time per batch (CUDA events), peak device memory and device
    time by kernel (``torch.profiler``) for one batch of ``folder``; returns
    ``{"ms_pair", "ms_batch", "peak_bytes", "kernels": {name: ms}}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchpiv_tpu_torch import MultipassPIV, PIVConfig
    from torchpiv_tpu_torch.io.dataset import PIVDataset
    from torchpiv_tpu_torch.pipeline import packed_forward

    _, a, b = PIVDataset(folder, ".bmp").read_batch(list(range(BATCH)))
    a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    engine = MultipassPIV(PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32,
                                    multipass=2, **cfg_kw), frame_mask=frame_mask)
    ms = cuda_ms(lambda: packed_forward(engine, a, b), reps=5)
    issue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed_forward(engine, a, b)
        issue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    issue_ms = float(np.median(issue)) * 1e3
    log(f"engine {label}: {ms:.3f} ms per batch of {BATCH} = {ms / BATCH:.3f} "
        f"ms/pair (device-resident uint8 frames, host tail excluded); the host "
        f"issues it in {issue_ms:.3f} ms (median of 5, no other thread busy)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    packed_forward(engine, a, b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"engine {label}: peak device memory {peak / 2**20:.1f} MiB in one batch, "
        f"{(peak - held) / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB held "
        f"before the call (uint8 frames, engine buffers)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        packed_forward(engine, a, b)
        torch.cuda.synchronize()
    # device-side events only (kernels, memcpy): an operator's row repeats
    # the time of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events)
    log(f"profile {label}: {total / 1e3:.3f} ms of device time in one batch")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"profile {label}: {e.self_device_time_total / 1e3:8.3f} ms  "
            f"x{e.count:<4d} {e.key[:90]}")
    return {"ms_pair": ms / BATCH, "ms_batch": ms, "issue_ms": issue_ms, "peak_bytes": peak,
            "device_ms": total / 1e3,
            "n_device_events": sum(e.count for e in events),
            "kernels": {e.key: e.self_device_time_total / 1e3 for e in events}}


def kernel_ms(profile: dict, word: str) -> float:
    """Device ms of the profile's kernels whose name holds ``word``."""
    return sum(t for name, t in profile["kernels"].items() if word in name.lower())


def check_fused_profile(fused: dict, unfused: dict, label: str) -> None:
    """No FFT-library kernel in a fused profile, and of the unfused
    profile's ``roll`` time (``fftshift`` of the maps, and the narrow strips
    of the flat-wrap pad) only the pad's share."""
    roll_kernel = "roll_cuda"  # not the "unrolled" elementwise kernels
    check(kernel_ms(unfused, "fft") > 0.0 and kernel_ms(unfused, roll_kernel) > 0.0,
          "the unfused profile shows no FFT or no roll kernel")
    fft, roll = kernel_ms(fused, "fft"), kernel_ms(fused, roll_kernel)
    log(f"profile {label}: FFT-library kernels {fft:.3f} ms, roll {roll:.3f} ms "
        f"(unfused: {kernel_ms(unfused, 'fft'):.3f} and "
        f"{kernel_ms(unfused, roll_kernel):.3f} ms)")
    check(fft == 0.0, f"{label}: an FFT-library kernel ran")
    check(roll < 0.1 * kernel_ms(unfused, roll_kernel), f"{label}: fftshift rolls ran")


def phase_reference(folder: str, label: str, frame_mask=None, **cfg_kw) -> None:
    """The CUDA engine against the CPU engine on one full-size pair."""
    from torchpiv_tpu_torch import MultipassPIV, PIVConfig
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    fa, fb = PIVDataset(folder, ".bmp")[0]
    cfg = PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32, multipass=2,
                    **cfg_kw)
    t0 = time.perf_counter()
    cu, cv, ci = (t.cpu().numpy() for t in MultipassPIV(
        cfg, device="cuda", frame_mask=frame_mask)(
            torch.from_numpy(fa), torch.from_numpy(fb)))
    pu, pv, pi = (t.numpy() for t in MultipassPIV(
        cfg, device="cpu", frame_mask=frame_mask)(
            torch.from_numpy(fa), torch.from_numpy(fb)))
    both = ~(ci | pi)
    flips = float((ci != pi).mean())
    diff = np.abs(np.concatenate([(cu - pu)[both], (cv - pv)[both]]))
    rms = float(np.sqrt(np.mean(diff ** 2)))
    log(f"reference {label}: CUDA vs CPU engine: mask mismatch {flips:.5f}, "
        f"RMS {rms:.3e} px, largest {diff.max():.3e} px, "
        f"{int((diff > 1e-3).sum())} of {diff.size} components above 1e-3 px, "
        f"on jointly valid vectors ({time.perf_counter() - t0:.1f} s)")
    check(flips < 0.02 and rms < 0.01, f"{label}: mask mismatch {flips}, RMS {rms}")


def block_rows(R: int, n_blocks: int):
    """``(rloc, origins)``: the clamped row blocks ``ShardedPIV`` gives
    ``n_blocks`` window shards of an ``R``-row grid."""
    from torchpiv_tpu_torch.parallel.sharded import _block_layout

    rloc, origins, _ = _block_layout(R, n_blocks)
    return rloc, [int(o) for o in origins]


def phase_row_blocks(frames: torch.Tensor) -> dict:
    """The seven resampling kernels at the pass-2 shape on 2 and 4 blocks of
    window rows (the last block clamped onto its neighbour), flat-wrap on
    and off: each block bit-equal to the same rows of the full launch and
    to its plain version on the block; the blocks' summed time (flat-wrap
    on) against the full launch.  Returns ``{kernel: {blocks: ms}}``."""
    from torchpiv_tpu_torch.kernels import deform as def_k
    from torchpiv_tpu_torch.kernels import shift as shift_k
    from torchpiv_tpu_torch.kernels.shift import variant_frame
    from torchpiv_tpu_torch.ops.shifts import VARIANTS
    from torchpiv_tpu_torch.ops.deform import def_operands, def_reference
    from torchpiv_tpu_torch.ops.shifts import (blend_reference_bicubic,
                                               blend_reference_variant,
                                               shift_operands)

    w, o = 32, 16
    n = window_count(w, o)
    R = (FRAME[0] - w) // (w - o) + 1
    C = n // R
    dev = frames.device
    g = torch.Generator(device="cpu").manual_seed(11)
    vx, vy = (t.to(dev) for t in shift_cases(n, g)["fractional"])
    grads = [((torch.rand(BATCH, n, generator=g) * 2 - 1) * 0.05).to(dev) for _ in range(4)]

    def sel(m, r0, rl):  # the maps of rows r0 .. r0 + rl - 1 (None: to the end)
        return m[:, r0 * C:None if rl is None else (r0 + rl) * C].contiguous()

    def shift_kind(interp="bilinear", variant="rolls"):
        def make(r0, rl, flat):
            return shift_operands(frames, sel(vx, r0, rl), sel(vy, r0, rl),
                                  frame_shape=FRAME, wind_size=w, overlap=o,
                                  flat_wrap=flat, interp=interp, row_start=r0,
                                  n_rows_local=rl)
        if interp == "bicubic":
            return make, (lambda ops, frame=None: shift_k.launch(ops, w, "bicubic")), \
                (lambda ops: blend_reference_bicubic(ops, w))
        if variant == "rolls":
            return make, (lambda ops, frame=None: shift_k.launch(ops, w)), \
                (lambda ops: blend_reference_variant(ops, w))
        # ``frame``: the variant's frame, made once for the timed launches
        # (the blocks share it), as phase 3 times the kernels
        return make, (lambda ops, frame=None: shift_k.launch_variant(
            ops, w, variant, frame=frame)), \
            (lambda ops: blend_reference_variant(ops, w, variant))

    def def_make(r0, rl, flat):
        return def_operands(frames, sel(vx, r0, rl), sel(vy, r0, rl),
                            *(sel(m, r0, rl) for m in grads), frame_shape=FRAME,
                            wind_size=w, overlap=o, margin=2, flat_wrap=flat,
                            row_start=r0, n_rows_local=rl)

    kinds = {"shift_windows": shift_kind(),
             "shift_windows_bicubic": shift_kind("bicubic"),
             "def_windows": (def_make, lambda ops, frame=None: def_k.launch(ops, w),
                             lambda ops: def_reference(ops, w))}
    for variant in ("bf16", "lanephases", "mxu", "phases"):
        kinds[f"shift_windows_{variant}"] = shift_kind(variant=variant)
    out = {}
    for name, (make, run, plain) in kinds.items():
        out[name] = {}
        for flat in (True, False):
            full_ops = make(0, R, flat)
            full = run(full_ops)
            variant = name.removeprefix("shift_windows_")
            vf = variant_frame(full_ops, variant) if variant in VARIANTS[1:] else None
            check(torch.equal(full, run(make(0, None, flat))),
                  f"{name}: row_start 0 with the default n_rows_local != full")
            for n_blocks in (2, 4):
                rloc, origins = block_rows(R, n_blocks)
                blocks = [make(r0, rloc, flat) for r0 in origins]
                for r0, ops in zip(origins, blocks):
                    got = run(ops)
                    check(torch.equal(got, full[:, r0 * C:(r0 + rloc) * C]),
                          f"{name} flat_wrap={flat}: block {r0}+{rloc} != the full "
                          f"launch's rows")
                    check(torch.equal(got, plain(ops)),
                          f"{name} flat_wrap={flat}: block {r0}+{rloc} != its plain "
                          f"version")
                    del got
                if flat:
                    out[name][n_blocks] = cuda_ms(lambda: [run(ops, vf) for ops in blocks])
                del blocks
            if flat:
                out[name][1] = cuda_ms(lambda: run(full_ops, vf))
            del full, full_ops
        rloc2, _ = block_rows(R, 2)
        rloc4, _ = block_rows(R, 4)
        log(f"row blocks {name}: full {out[name][1]:.4f} ms; 2 blocks of {rloc2} rows "
            f"{out[name][2]:.4f} ms ({out[name][2] / out[name][1]:.3f}x, rows "
            f"{2 * rloc2 / R:.3f}x); 4 blocks of {rloc4} rows {out[name][4]:.4f} ms "
            f"({out[name][4] / out[name][1]:.3f}x, rows {4 * rloc4 / R:.3f}x); every "
            f"block bit-equal to the full launch's rows and to its plain version, "
            f"flat-wrap on and off")
        torch.cuda.empty_cache()
    return out


def first_batch(folder: str):
    """The first ``BATCH`` pairs of ``folder`` as uint8 tensors on the card."""
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    _, a, b = PIVDataset(folder, ".bmp").read_batch(list(range(BATCH)))
    return torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()


def mesh_parity(engine, sharded, a, b, label: str) -> dict:
    """The sharded engine against the unsharded one on one batch: the
    valid share, the mask mismatch and the RMS on jointly valid vectors
    (the port's parity budget: < 2% and < 0.01 px)."""
    u0, v0, i0 = engine(a, b)
    u1, v1, i1 = sharded(a, b)
    both = ~(i0 | i1)
    valid = 1.0 - i1.float().mean().item()
    flips = (i0 != i1).float().mean().item()
    diff = torch.cat([(u1 - u0)[both], (v1 - v0)[both]]).abs()
    rms = diff.square().mean().sqrt().item()
    log(f"{label}: valid share {valid:.4f}, mask mismatch {flips:.5f}, RMS "
        f"{rms:.3e} px, largest {diff.max().item():.3e} px against the unsharded "
        f"engine on one batch")
    check(valid > 0.95, f"{label}: valid share {valid}")
    check(flips < 0.02 and rms < 0.01, f"{label}: mask mismatch {flips}, RMS {rms}")
    return {"valid": valid, "mismatch": flips, "rms": rms}


NCCL_CHILD = """
import torch
import torch.distributed as dist
from torchpiv_tpu_torch.parallel import initialize_distributed
rank, size = initialize_distributed()
x = torch.full((4,), 2.0, device="cuda")
dist.all_reduce(x)
torch.cuda.synchronize()
print("nccl group", dist.get_backend(), rank, size, x.tolist(), flush=True)
ok = dist.get_backend() == "nccl" and (rank, size) == (0, 1) and x.tolist() == [2.0] * 4
dist.destroy_process_group()
raise SystemExit(0 if ok else 1)
"""


def phase_nccl_group() -> None:
    """A one-rank NCCL group through ``initialize_distributed`` (the
    launcher's ``env://`` variables, ``TPIV_COORDINATOR=auto``) and an
    all_reduce of a CUDA tensor, in a child process that is killed after
    180 s."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "TPIV_COORDINATOR": "auto", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port), "RANK": "0", "WORLD_SIZE": "1"}
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", NCCL_CHILD], env=env, timeout=180,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True)
    log(f"{run.stdout.strip()} (rc {run.returncode}, "
        f"{time.perf_counter() - t0:.1f} s)")
    check(run.returncode == 0, f"the one-rank NCCL group failed: {run.stderr[-2000:]}")


def device_time(fn) -> list:
    """``[device ms, device events]`` of one call of ``fn``: the sum of the
    kernels' and copies' times in ``torch.profiler``, and their count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return [sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events)]


def phase_mesh(uniform: str, shear: str, rough: str, cws_fields, bg_fields,
               kernels) -> dict:
    """``OfflinePIV(mesh=)`` and ``ShardedPIV`` on the card (the one card
    named once, twice or four times); returns the sharded engines' device
    ms and device events a batch."""
    from torchpiv_tpu_torch import MultipassPIV, OfflinePIV, PIVConfig
    from torchpiv_tpu_torch.parallel import ShardedPIV, make_mesh
    from torchpiv_tpu_torch.parallel.meshprof import profile

    card = torch.device("cuda", torch.cuda.current_device())
    kw = dict(wind_size=64, overlap=32, multipass=2, multipass_mode="CWS",
              batch_size=BATCH)
    n_batches = -(-N_PAIRS // BATCH)
    piv = OfflinePIV(uniform, mesh=make_mesh({"pairs": 1}, [card]), **kw)
    fields, launches, pairs_per_s = drive(piv, kernels)
    check_fields(fields, piv, N_PAIRS)
    check(launches == only(launches, shift_windows=2 * n_batches),
          f"one-device mesh launches {launches}")
    same_fields(fields, cws_fields, "one-device mesh")
    check(len(fields) == len(cws_fields), "one-device mesh: a pair is missing")
    log(f"mesh {{'pairs': 1}}: {pairs_per_s:.3f} pairs/s, fields bit-equal to the "
        f"unsharded CWS path")
    # background="auto" over a mesh: the decode workers subtract it on the
    # host, the unsharded path on the card
    piv = OfflinePIV(rough, mesh=make_mesh({"pairs": 1}, [card]), background="auto",
                     max_pairs=BATCH, **kw)
    fields, launches, _, spans = drive_with_spans(piv, kernels,
                                                  "mesh {'pairs': 1} background=auto")
    check_fields(fields, piv, BATCH)
    check(launches == only(launches, shift_windows=2),
          f"mesh background=auto: launches {launches}")
    same_fields(fields, bg_fields, "mesh background=auto")
    check(len(fields) == len(bg_fields), "mesh background=auto: a pair is missing")
    log("mesh {'pairs': 1} background=auto: fields bit-equal to the unsharded "
        "background=auto run")

    a, b = first_batch(uniform)
    for axes, n_dev in (({"pairs": 1, "windows": 2}, 2), ({"pairs": 2, "windows": 2}, 4)):
        label = f"mesh {axes} over the card x{n_dev}"
        piv = OfflinePIV(uniform, mesh=make_mesh(axes, [card] * n_dev), **kw)
        fields, launches, pairs_per_s = drive(piv, kernels)
        check_fields(fields, piv, N_PAIRS)
        # a batch: one shift launch a frame on each of the pair x window shards
        want = 2 * axes["pairs"] * axes["windows"] * n_batches
        check(launches == only(launches, shift_windows=want), f"{label}: launches {launches}")
        check_displacement(fields, label)
        worst = max(max(np.abs(x[2] - y[2]).max(), np.abs(x[3] - y[3]).max())
                    for x, y in zip(fields, cws_fields)) / UNIT
        log(f"{label}: {pairs_per_s:.3f} pairs/s, launches {launches}, largest field "
            f"difference from the unsharded path {worst:.3e} px (after the host tail)")
        mesh_parity(piv.engine, piv._sharded, a, b, label)

    # one batch each of the other paths under the window split
    mesh = make_mesh({"pairs": 1, "windows": 2}, [card] * 2)
    sa, sb = first_batch(shear)
    for label, folder_ab, cfg_kw, want in (
            ("DEF peakfit=pallas", (sa, sb), dict(multipass_mode="DEF", peakfit="pallas"),
             dict(def_windows=4, peakfit=4)),
            ("CWS bicubic", (sa, sb), dict(cws_interp="bicubic"),
             dict(shift_windows_bicubic=4)),
            *((f"CWS shift_variant={v}", (a, b), dict(shift_variant=v),
               {f"shift_windows_{v}": 4}) for v in ("bf16", "lanephases", "mxu", "phases"))):
        engine = MultipassPIV(PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32,
                                        multipass=2, **cfg_kw))
        sharded = ShardedPIV(engine, mesh)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        u, _, _ = sharded(*folder_ab)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        check(launches == only(launches, **want),
              f"window split {label}: launches {launches}")
        check(tuple(u.shape) == (BATCH, *engine.final_field_shape)
              and bool(torch.isfinite(u).all()), f"window split {label}: fields")
        mesh_parity(engine, sharded, *folder_ab, f"window split {label}")

    rows = profile(frame_shape=FRAME, wind_size=64, overlap=32, multipass=2,
                   splits=[1, 2, 4], reps=5, log=log, devices=[card] * 4, batch=BATCH)
    log(json.dumps({"meshprof": rows}))
    phase_nccl_group()
    # device ms a batch: the kernels' and copies' time in the profiler (a
    # spin cannot queue these calls: a split engine's launches fill the
    # card's launch queue before the spin ends); meshprof's table above
    # times host-issued steps with events
    engine = MultipassPIV(PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32,
                                    multipass=2))
    device_ms = {"unsharded": device_time(lambda: engine(a, b))}
    for axes, n_dev in (({"pairs": 1, "windows": 2}, 2), ({"pairs": 2, "windows": 2}, 4),
                        ({"pairs": 1, "windows": 4}, 4)):
        sharded = ShardedPIV(engine, make_mesh(axes, [card] * n_dev))
        device_ms[json.dumps(axes)] = device_time(lambda: sharded(a, b))
    log("mesh engines, CWS w64/o32 2-pass, a batch of "
        f"{BATCH}: [device ms, device events] {json.dumps(device_ms)}")
    torch.cuda.empty_cache()
    return device_ms


CAMERA_HZ = 8.0  # pairs a second: a double-pulse PIV camera
POLL_S = 0.02  # the streaming runs' folder poll
CATCHUP = 4  # OnlinePIV's catch-up chunk


def zero_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read_counts(kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def within_budget(got, want, label: str) -> None:
    """Fields within the parity budget of the ones they are held against:
    ``x, y`` equal, ``u, v`` within RMS 0.01 px, under 2% of the components
    more than 0.01 px apart."""
    check(len(got) == len(want), f"{label}: {len(got)} fields against {len(want)}")
    for (gx, gy, gu, gv), (wx, wy, wu, wv) in zip(got, want):
        check(np.array_equal(gx, wx) and np.array_equal(gy, wy), f"{label}: x, y differ")
        d = np.abs(np.concatenate([(gu - wu).ravel(), (gv - wv).ravel()])) / UNIT
        check(np.sqrt(np.mean(d ** 2)) < 0.01 and (d > 0.01).mean() < 0.02,
              f"{label}: RMS {np.sqrt(np.mean(d ** 2))} px, "
              f"{(d > 0.01).mean()} over 0.01 px")


def bring_in(folder: str, i: int, which: str, data: bytes) -> None:
    """Frame ``which`` of pair ``i``, written under a name the watcher
    ignores and renamed into ``folder``: it never lands half-written."""
    part = os.path.join(folder, f".p{i}_{which}.part")
    with open(part, "wb") as f:
        f.write(data)
    os.replace(part, os.path.join(folder, f"p{i}_{which}.bmp"))


def online_stream(folder: str):
    from torchpiv_tpu_torch import OnlinePIV

    os.makedirs(folder)
    # idle_timeout only bounds a run whose pairs never all come out
    return OnlinePIV(folder, wind_size=64, overlap=32, multipass=2,
                     poll_interval=POLL_S, idle_timeout=60.0,
                     catchup_batch=CATCHUP, frame_shape=FRAME)


def drain_stream(piv, n: int):
    """The stream's fields and the time each came out; stops it after
    ``n`` fields."""
    fields, out_t = [], []
    for res in piv():
        out_t.append(time.perf_counter())
        fields.append(res)
        if len(fields) == n:
            piv.stop()
    return fields, out_t


def phase_online(uniform: str, tmp: str, kernels, cws_fields, smi: str) -> dict:
    """``OnlinePIV`` at camera rate and in a burst over the uniform pairs
    (see ``phase_streaming``); returns the readings."""
    data = []
    for i in range(N_PAIRS):
        with open(os.path.join(uniform, f"p{i}_a.bmp"), "rb") as fa, \
                open(os.path.join(uniform, f"p{i}_b.bmp"), "rb") as fb:
            data.append((fa.read(), fb.read()))
    out = {}

    # camera rate: the camera starts once the stream has warmed on its own
    folder = os.path.join(tmp, "camera")
    piv = online_stream(folder)
    renamed = {}

    def camera():
        deadline = time.monotonic() + 120
        while piv.dispatches["warm"] < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        t_next = time.perf_counter()
        for i, (a, b) in enumerate(data):
            time.sleep(max(0.0, t_next - time.perf_counter()))
            bring_in(folder, i, "a", a)
            bring_in(folder, i, "b", b)
            renamed[i] = time.perf_counter()
            t_next += 1.0 / CAMERA_HZ

    zero_counts(kernels)
    writer = threading.Thread(target=camera, name="camera", daemon=True)
    writer.start()
    fields, out_t = drain_stream(piv, N_PAIRS)
    writer.join(timeout=60)
    launches = read_counts(kernels)
    check(not writer.is_alive() and len(renamed) == N_PAIRS, "the camera did not finish")
    calls = sum(piv.dispatches.values())
    log(f"OnlinePIV at {CAMERA_HZ} Hz: engine calls {dict(piv.dispatches)}, "
        f"launches {launches}")
    check_fields(fields, piv, N_PAIRS)
    check(piv.dispatches["warm"] == 2, f"warm calls {dict(piv.dispatches)}")
    check(launches == only(launches, shift_windows=2 * calls),
          f"OnlinePIV at {CAMERA_HZ} Hz: launches {launches} for {calls} engine calls")
    check_displacement(fields, f"OnlinePIV at {CAMERA_HZ} Hz")
    valid = warm_up(piv, uniform)
    check(valid > 0.95, f"OnlinePIV valid share {valid}")
    within_budget(fields, cws_fields, f"OnlinePIV at {CAMERA_HZ} Hz against OfflinePIV")
    lat = [1e3 * (out_t[i] - renamed[i]) for i in range(N_PAIRS)]
    out["camera"] = {"single_pairs": piv.dispatches["single"],
                     "catchup_pairs": CATCHUP * piv.dispatches["catchup"],
                     "latency_ms_median": float(np.median(lat)),
                     "latency_ms_max": float(max(lat)), "latency_ms": lat}
    log(f"OnlinePIV at {CAMERA_HZ} Hz (poll {POLL_S} s, {smi}): "
        f"{out['camera']['single_pairs']} pairs single, "
        f"{out['camera']['catchup_pairs']} in catch-up; latency from the rename of "
        f"a _b frame to its field: median {out['camera']['latency_ms_median']:.1f} ms, "
        f"largest {out['camera']['latency_ms_max']:.1f} ms; valid share {valid:.4f}")

    # a burst: every pair renamed in before the first poll
    folder = os.path.join(tmp, "burst")
    piv = online_stream(folder)
    for i, (a, b) in enumerate(data):
        bring_in(folder, i, "a", a)
        bring_in(folder, i, "b", b)
    zero_counts(kernels)
    t0 = time.perf_counter()
    fields, out_t = drain_stream(piv, N_PAIRS)
    launches = read_counts(kernels)
    log(f"OnlinePIV burst: engine calls {dict(piv.dispatches)}, launches {launches}")
    check_fields(fields, piv, N_PAIRS)
    check(dict(piv.dispatches) == {"warm": 2, "catchup": N_PAIRS // CATCHUP},
          f"OnlinePIV burst: engine calls {dict(piv.dispatches)}")
    check(launches == only(launches, shift_windows=2 * (2 + N_PAIRS // CATCHUP)),
          f"OnlinePIV burst: launches {launches}")
    check_displacement(fields, "OnlinePIV burst")
    within_budget(fields, cws_fields, "OnlinePIV burst against OfflinePIV")
    out["burst"] = {"catchup_calls": piv.dispatches["catchup"],
                    "last_field_s": out_t[-1] - t0}
    log(f"OnlinePIV burst of {N_PAIRS} pairs ({smi}): {piv.dispatches['catchup']} "
        f"catch-up calls of {CATCHUP}, last field {out['burst']['last_field_s']:.3f} s "
        f"after the stream started (its two warm calls included)")
    return out


def phase_video(uniform: str, tmp: str, kernels, cws_fields, smi: str) -> dict:
    """``VideoPIV`` over the 16 frames of the uniform pairs, ``folder_mode=
    "pairs"``, batch 4, bit-equal to ``OfflinePIV`` at batch 4; once more
    with a short last batch (``max_pairs=7``).  Without OpenCV a stand-in
    reads the decoded frames (``video_stand_in``)."""
    from torchpiv_tpu_torch import OfflinePIV, VideoPIV
    from torchpiv_tpu_torch.io import video as video_mod
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    ds = PIVDataset(uniform, ".bmp")
    frames = [f for i in range(N_PAIRS) for f in ds[i]]
    path = os.path.join(tmp, "uniform.avi")
    real = video_mod.cv2
    if real is None:
        reader = "a stand-in over the decoded frames (no OpenCV here)"
        video_mod.cv2 = video_stand_in({path: frames})
    else:  # lossless, so the frames stay the BMPs' to the bit
        reader = f"OpenCV {real.__version__}, FFV1"
        wr = real.VideoWriter(path, real.VideoWriter_fourcc(*"FFV1"), 10,
                              FRAME[::-1], False)
        check(wr.isOpened(), "OpenCV cannot write FFV1")
        for f in frames:
            wr.write(f)
        wr.release()
    out = {"reader": reader}
    try:
        for max_pairs in (None, N_PAIRS - 1):
            n = max_pairs or N_PAIRS
            label = f"VideoPIV max_pairs={max_pairs}"
            piv = VideoPIV(path, wind_size=64, overlap=32, multipass=2,
                           folder_mode="pairs", batch_size=BATCH, max_pairs=max_pairs)
            zero_counts(kernels)
            t0 = time.perf_counter()
            fields = list(piv())
            wall = time.perf_counter() - t0
            launches = read_counts(kernels)
            check(len(piv) == len(fields) == n, f"{label}: {len(fields)} fields")
            check(launches == only(launches, shift_windows=2 * -(-n // BATCH)),
                  f"{label}: launches {launches}")
            want = cws_fields if max_pairs is None else list(OfflinePIV(
                uniform, wind_size=64, overlap=32, multipass=2, batch_size=BATCH,
                max_pairs=max_pairs)())
            check(len(want) == n, f"{label}: OfflinePIV gave {len(want)} fields")
            same_fields(fields, want, f"{label} against OfflinePIV at batch {BATCH}")
            out[str(max_pairs)] = n / wall
            log(f"{label} ({reader}; {smi}): {n} pairs at {n / wall:.3f} pairs/s, "
                f"bit-equal to OfflinePIV at batch {BATCH}, launches {launches}")
    finally:
        video_mod.cv2 = real
    return out


def phase_runner(uniform: str, tmp: str, kernels, cws_fields, smi: str) -> dict:
    """``PIVRunner`` over the uniform pairs, ``save_opt="Save all text"``,
    a checkpoint every batch, batch 4: the per-pair files and the table,
    its mean velocity against the mean of ``OfflinePIV``'s fields, progress,
    and the checkpoint removed at the end."""
    import glob

    from torchpiv_tpu_torch.pipeline import PIVRunner
    from torchpiv_tpu_torch.utils.config import PIVParams

    save_dir = os.path.join(tmp, "runner_out")
    ckpt = os.path.join(tmp, "runner.ckpt.npz")
    params = PIVParams(folder=uniform, wind_size=64, overlap=32, multipass=2,
                       save_opt="Save all text", save_dir=save_dir)
    progress, ckpt_seen = [], []
    runner = PIVRunner(params, on_progress=progress.append,
                       on_output=lambda out: ckpt_seen.append(os.path.exists(ckpt)),
                       checkpoint_path=ckpt, checkpoint_every=BATCH, batch_size=BATCH)
    zero_counts(kernels)
    t0 = time.perf_counter()
    table = runner.run()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(table is not None and progress[-1] == 100, f"PIVRunner progress {progress}")
    check(launches == only(launches, shift_windows=2 * N_PAIRS // BATCH),
          f"PIVRunner launches {launches}")
    # written after the first batch's last pair, removed at the end
    check(ckpt_seen == [False] * BATCH + [True] * (N_PAIRS - BATCH)
          and not os.path.exists(ckpt), f"PIVRunner checkpoint {ckpt_seen}")
    files = sorted(glob.glob(os.path.join(save_dir, "uniform_pair*.txt")))
    stats = glob.glob(os.path.join(save_dir, "uniform_statistics.txt"))
    check(len(files) == N_PAIRS and len(stats) == 1,
          f"PIVRunner wrote {len(files)} pair files and {len(stats)} tables")
    first = np.loadtxt(os.path.join(save_dir, "uniform_pair.txt"), delimiter=",",
                       skiprows=1)
    check(np.abs(first[:, 2] - cws_fields[0][2].ravel()).max() < 6e-7,
          "PIVRunner: the first pair's file is not OfflinePIV's field")
    worst = 0.0
    for col, k in (("Vx[m/s]", 2), ("Vy[m/s]", 3)):
        mean = np.mean([f[k] for f in cws_fields], axis=0)
        err = float(np.abs(table[col] - mean).max() / np.abs(mean).max())
        worst = max(worst, err)
        check(err < 1e-12, f"PIVRunner {col}: relative difference {err}")
    log(f"PIVRunner ({smi}): {N_PAIRS} pairs in {wall:.3f} s with per-pair text "
        f"saves, {len(files)} files and the table; table mean against OfflinePIV's "
        f"fields: largest relative difference {worst:.3e}; launches {launches}")
    return {"pairs_per_s": N_PAIRS / wall}


def metric(text: str, name: str) -> float:
    (line,) = [l for l in text.splitlines() if l.startswith(name + " ")]
    return float(line.split()[1])


def phase_service(uniform: str, kernels, cws_fields, smi: str) -> dict:
    """``PIVService`` behind ``make_server`` on 127.0.0.1, warmed up first
    and driven by ``PIVClient``, with ``TPIV_SERVE_SCAN_B=4``: one pair (within the parity
    budget of ``OfflinePIV``'s field), the 8 pairs as a burst (bit-equal to
    ``OfflinePIV`` at batch 4), a file pair, health, config and metrics;
    then a second service with ``fused="on"`` answers the burst."""
    from torchpiv_tpu_torch.client import PIVClient
    from torchpiv_tpu_torch.io.dataset import PIVDataset
    from torchpiv_tpu_torch.serve import PIVService, make_server

    ds = PIVDataset(uniform, ".bmp")
    stack_a = np.stack([ds[i][0] for i in range(N_PAIRS)])
    stack_b = np.stack([ds[i][1] for i in range(N_PAIRS)])
    out = {}
    for label, options in (("PIVService", {}), ("PIVService fused=on", {"fused": "on"})):
        os.environ["TPIV_SERVE_SCAN_B"] = str(BATCH)
        service = PIVService(wind_size=64, overlap=32, multipass=2,
                             engine_options=options)
        del os.environ["TPIV_SERVE_SCAN_B"]
        # as a server starts: the engine built and both paths run once
        t0 = time.perf_counter()
        service.warmup(FRAME)
        warm_ms = 1e3 * (time.perf_counter() - t0)
        srv = make_server(service, "127.0.0.1", 0)
        serving = threading.Thread(target=srv.serve_forever, name="serve", daemon=True)
        serving.start()
        try:
            client = PIVClient("http://%s:%d" % srv.server_address)
            zero_counts(kernels)
            calls, req_ms = 0, {"warmup": warm_ms}
            if not options:
                t0 = time.perf_counter()
                single = client.analyze(stack_a[0], stack_b[0])
                req_ms["pair"] = 1e3 * (time.perf_counter() - t0)
                within_budget([single[:4]], cws_fields[:1], f"{label} one pair")
                calls += 1
            t0 = time.perf_counter()
            burst = client.analyze_burst(stack_a, stack_b)
            req_ms["burst"] = 1e3 * (time.perf_counter() - t0)
            calls += N_PAIRS // BATCH
            check(not burst["skipped_pairs"].any(), f"{label}: a pair was skipped")
            fields = [(burst["x"], burst["y"], burst["u"][i], burst["v"][i])
                      for i in range(N_PAIRS)]
            check_displacement(fields, f"{label} burst")
            if not options:
                same_fields(fields, cws_fields, f"{label} burst against OfflinePIV")
                t0 = time.perf_counter()
                files = client.analyze_files(os.path.join(uniform, "p0_a.bmp"),
                                             os.path.join(uniform, "p0_b.bmp"))
                req_ms["files"] = 1e3 * (time.perf_counter() - t0)
                calls += 1
                check(all(np.array_equal(f, s) for f, s in zip(files, single)),
                      f"{label}: the file pair differs from the same pair posted")
            launches = read_counts(kernels)
            kernel = "fused_piv_pass" if options else "shift_windows"
            check(launches == only(launches, **{kernel: 2 * calls}),
                  f"{label}: launches {launches} for {calls} engine calls")
            health, config, text = client.health(), client.config(), client.metrics()
            check(health["ok"] and health["compiled_shapes"] == [list(FRAME)]
                  and health["device"].startswith("cuda"), f"{label}: health {health}")
            check(config["wind_size"] == 64 and config.get("fused", "auto")
                  == options.get("fused", "auto"), f"{label}: config {config}")
            served = metric(text, "tpiv_pairs_served")
            # the warm-up's pair counts, as in the JAX package
            check(served == 1 + N_PAIRS + (0 if options else 2),
                  f"{label}: {served} pairs served")
            out[label] = {"requests_ms": req_ms,
                          "pair_latency_ms_median": metric(text, "tpiv_latency_ms_median"),
                          "pair_latency_ms_p95": metric(text, "tpiv_latency_ms_p95")}
            log(f"{label} ({smi}): requests {json.dumps(req_ms)} ms; /metrics per-pair "
                f"latency median {out[label]['pair_latency_ms_median']} ms, p95 "
                f"{out[label]['pair_latency_ms_p95']} ms over {int(served)} pairs; "
                f"launches {launches}")
        finally:
            srv.shutdown()
            srv.server_close()
            serving.join(timeout=30)
    return out


def phase_streaming(uniform: str, tmp: str, kernels, cws_fields, smi: str) -> dict:
    """Phase 10: the streaming front ends, the runner and the service at
    the main path's full width (4 MP, w64/o32, 2-pass CWS, the host
    infill tail)."""
    out = {"online": phase_online(uniform, tmp, kernels, cws_fields, smi)}
    out["video"] = phase_video(uniform, tmp, kernels, cws_fields, smi)
    out["runner"] = phase_runner(uniform, tmp, kernels, cws_fields, smi)
    out["service"] = phase_service(uniform, kernels, cws_fields, smi)
    log(json.dumps({"streaming": out, "card": smi}))
    return out


# ---- phase 11: the other device-path models ----------------------------------

N_ENSEMBLE = 16  # sparse pairs of the ensemble: seeds 200-215
ENSEMBLE_DENSITY = 0.002  # particles a pixel: micro-PIV seeding
SEQ_DU = 0.8  # px/frame of the multi-frame sequence
SEPARATIONS = (1, 2, 4)
HYBRID_DISPLACEMENT = (11.0, 0.0)  # beyond dense LK's capture range
PTV_DENSITY = 0.003  # about 12.6k particles at 2048 x 2048
PTV_CAPACITY = 16384
REFERENCE_FRAME = (1024, 1024)  # the CUDA-against-CPU pair
# the correlation peak of particle images of diameter 2.5 px: their
# autocorrelation, sigma = sqrt(2) * 2.5 / 2.354
PEAK_SIGMA = float(np.sqrt(2.0) * 2.5 / 2.354)


def call_times(fn, reps: int = 3) -> dict:
    """A call's device time and device events (``device_time``, one call
    under ``torch.profiler``) beside its time on the card's clock (CUDA
    events around ``reps`` calls, ``cuda_ms``: the host's waits count
    there, as in a user's loop)."""
    dev_ms, events = device_time(fn)
    return {"device_ms": dev_ms, "events": events, "call_ms": cuda_ms(fn, reps=reps)}


def times_text(t: dict) -> str:
    return (f"{t['device_ms']:.3f} ms of device time in {t['events']} device events, "
            f"{t['call_ms']:.3f} ms a call on the card's clock")


def sparse_batch(shape, n: int, seed: int, density: float):
    """``n`` pairs at the uniform displacement and ``density``, seeds
    ``seed .. seed + n - 1``, as ``[n, H, W]`` tensors."""
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    pairs = [particle_pair(shape, DISPLACEMENT, density=density, seed=seed + i)
             for i in range(n)]
    return (torch.from_numpy(np.stack([p[0] for p in pairs])),
            torch.from_numpy(np.stack([p[1] for p in pairs])))


def moving_sequence(shape, du: float, seed: int) -> np.ndarray:
    """Five ``render_particles`` frames of one particle set moving ``du`` px
    a frame in x."""
    from torchpiv_tpu_torch.utils.synthetic import render_particles

    rng = np.random.default_rng(seed)
    H, W = shape
    n = int(0.02 * H * W)
    xs, ys = rng.uniform(0, W, n), rng.uniform(0, H, n)
    inten = rng.uniform(100, 220, n)
    return np.stack([np.clip(render_particles(shape, xs + du * t, ys, inten), 0, 255)
                     .astype(np.uint8) for t in range(5)])


def models_ensemble(kernels, smi: str) -> None:
    """``EnsemblePIV`` over the 16 sparse pairs, w64/o32, both peak fits."""
    from torchpiv_tpu_torch import MultipassPIV, PIVConfig
    from torchpiv_tpu_torch.models import EnsemblePIV

    A, B = sparse_batch(FRAME, N_ENSEMBLE, 200, ENSEMBLE_DENSITY)
    A, B = A.cuda(), B.cuda()
    for fit in ("xla", "pallas"):
        label = f"EnsemblePIV peakfit={fit}"
        cfg = PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32, multipass=1, peakfit=fit)
        em = EnsemblePIV(cfg)
        zero_counts(kernels)
        u, v, inval = em(A, B)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        check(launches == only(launches, peakfit=1 if fit == "pallas" else 0),
              f"{label}: launches {launches}")
        ok = ~inval
        share = float(ok.float().mean())
        mu, mv = float(u[ok].mean()), float(v[ok].mean())
        check(share > 0.95, f"{label}: valid share {share}")
        check(abs(mu - DISPLACEMENT[0]) < 0.05 and abs(mv - DISPLACEMENT[1]) < 0.05,
              f"{label}: mean displacement ({mu}, {mv})")
        acc = sum(em.corr_batch(A[s], B[s]) for s in (slice(0, 8), slice(8, 16)))
        su, sv, sinval = em.finalize(acc / N_ENSEMBLE)
        gap = float(torch.maximum((su - u).abs(), (sv - v).abs()).max())
        check(gap <= 1e-4 and torch.equal(sinval, inval),
              f"{label}: two batches of 8 summed differ by {gap} px")
        t = call_times(lambda: em(A, B))
        log(f"{label} ({smi}): {N_ENSEMBLE} pairs at density {ENSEMBLE_DENSITY}, mean "
            f"({mu:.4f}, {mv:.4f}) px on valid windows, valid share {share:.4f}; "
            f"corr_batch over 2 x 8 within {gap:.3e} px of one call; peakfit launches "
            f"{launches['peakfit']}; a batch of {N_ENSEMBLE}: {times_text(t)}")
    engine = MultipassPIV(PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32, multipass=1))
    single = float((~engine(A, B)[2]).float().mean())
    log(f"EnsemblePIV ({smi}): the single-pair engine on the same pairs: valid share "
        f"{single:.4f} (the ensemble's {share:.4f})")


def models_multidt(kernels, smi: str) -> None:
    """``MultiDtPIV`` on a 5-frame sequence at 0.8 px/frame, separations
    (1, 2, 4), 2-pass CWS w64/o32: one engine call over the 3 pairs."""
    from torchpiv_tpu_torch import PIVConfig
    from torchpiv_tpu_torch.models import MultiDtPIV

    frames = moving_sequence(FRAME, SEQ_DU, seed=500)
    mdt = MultiDtPIV(PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32, multipass=2),
                     separations=SEPARATIONS)
    mdt(frames, 0)  # cuFFT plans for the batch of 3
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    res = mdt(frames, 0)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(kernels)
    check(launches == only(launches, shift_windows=2), f"MultiDtPIV: launches {launches}")
    ok = ~res.invalid
    mu = float(res.u[ok].mean())
    long_share = float((res.dt_map == SEPARATIONS[-1]).mean())
    check(abs(mu - SEQ_DU) < 0.02, f"MultiDtPIV: mean u {mu} px/frame")
    check(long_share >= 0.95, f"MultiDtPIV: dt_map == 4 on {long_share}")
    dev = torch.from_numpy(frames).cuda()
    t = call_times(lambda: mdt.engine(dev[:1].expand(3, -1, -1), dev[[1, 2, 4]]))
    log(f"MultiDtPIV ({smi}): mean u {mu:.4f} px/frame (expected {SEQ_DU}), dt_map == 4 "
        f"on {long_share:.4f}, valid share {float(ok.mean()):.4f}; shift_windows "
        f"launches {launches['shift_windows']} for the one batched call; the engine "
        f"on the 3 pairs: {times_text(t)}; {wall_ms:.1f} ms a snapshot on the host "
        f"clock (frames from the host, merge included)")


def models_folki(fa: np.ndarray, fb: np.ndarray, kernels, smi: str) -> None:
    """``FolkiPIV`` dense (w32/o16, radius 8, 8 iterations, 3 levels) on the
    first uniform pair, and hybrid on an (11, 0) px pair with a 2-pass CWS
    w64/o32 engine."""
    from torchpiv_tpu_torch import PIVConfig
    from torchpiv_tpu_torch.models import FolkiPIV, folki_flow
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    fp = FolkiPIV(FRAME, 32, 16)
    a, b = torch.from_numpy(fa).cuda(), torch.from_numpy(fb).cuda()
    u, v = (t.cpu().numpy() for t in folki_flow(a, b))
    du = float(np.abs(u[24:-24, 24:-24] - DISPLACEMENT[0]).mean())
    dv = float(np.abs(v[24:-24, 24:-24] - DISPLACEMENT[1]).mean())
    ug, vg, bad = fp(a, b)
    gu = float(np.abs(ug[2:-2, 2:-2] - DISPLACEMENT[0]).mean())
    check(du < 0.03 and dv < 0.03, f"folki_flow: interior mean abs error ({du}, {dv})")
    check(gu < 0.03 and bad.mean() < 0.2, f"FolkiPIV: grid error {gu}, bad {bad.mean()}")
    dense = call_times(lambda: fp.grid_output(a, b, *folki_flow(a, b)))
    log(f"FolkiPIV dense ({smi}): interior mean abs error ({du:.4f}, {dv:.4f}) px "
        f"dense, {gu:.4f} px on the grid, bad share {bad.mean():.4f}; a pair (flow "
        f"and grid fit, on the card): {times_text(dense)}")
    ha, hb = particle_pair(FRAME, HYBRID_DISPLACEMENT, seed=600)
    cfg = PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32, multipass=2)
    hp = FolkiPIV(FRAME, 32, 16, piv_config=cfg)
    hp(ha, hb)  # cuFFT plans
    zero_counts(kernels)
    hu, hv, hbad = hp(ha, hb)
    launches = read_counts(kernels)
    check(launches == only(launches, shift_windows=2), f"FolkiPIV hybrid: launches {launches}")
    eu = float(np.abs(hu - HYBRID_DISPLACEMENT[0]).mean())
    ev = float(np.abs(hv - HYBRID_DISPLACEMENT[1]).mean())
    check(eu < 0.05 and ev < 0.05, f"FolkiPIV hybrid: mean abs error ({eu}, {ev})")
    a2, b2 = torch.from_numpy(ha).cuda(), torch.from_numpy(hb).cuda()
    hybrid = call_times(lambda: hp(a2, b2))
    log(f"FolkiPIV hybrid ({smi}): mean abs error ({eu:.4f}, {ev:.4f}) px at "
        f"{HYBRID_DISPLACEMENT} px, invalid share {hbad.mean():.4f}, shift_windows "
        f"launches {launches['shift_windows']}; a pair (the call waits for the "
        f"engine's field on the host): {times_text(hybrid)}")


def models_ptv(kernels, smi: str) -> None:
    """``PTV`` at PTV seeding (density 0.003, capacity 16384), plain and
    PIV-guided (2-pass CWS w64/o32), one run with the left half masked, and
    ``bin_to_grid`` of the guided tracks."""
    from torchpiv_tpu_torch import PIVConfig
    from torchpiv_tpu_torch.models import PTV, bin_to_grid, match_particles
    from torchpiv_tpu_torch.ops.particles import detect_particles
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    fa, fb = particle_pair(FRAME, DISPLACEMENT, density=PTV_DENSITY, seed=700)
    cfg = PIVConfig(frame_shape=FRAME, wind_size=64, overlap=32, multipass=2)
    half = np.zeros(FRAME, bool)
    half[:, :FRAME[1] // 2] = True
    frames = torch.from_numpy(np.stack([fa, fb])).cuda()
    tracks = {}
    for label, kw in (("plain", {}), ("guided", {"piv_config": cfg}),
                      ("guided, left half masked", {"piv_config": cfg, "frame_mask": half})):
        ptv = PTV(FRAME, max_particles=PTV_CAPACITY, **kw)
        ptv(fa, fb)  # cuFFT plans
        zero_counts(kernels)
        res = ptv(fa, fb)
        launches = read_counts(kernels)
        want = 2 if "piv_config" in kw else 0
        check(launches == only(launches, shift_windows=want), f"PTV {label}: launches {launches}")
        mu, mv = float(np.median(res.u)), float(np.median(res.v))
        matched = len(res.x) / max(res.n_a, 1)
        check(abs(mu - DISPLACEMENT[0]) < 0.05 and abs(mv - DISPLACEMENT[1]) < 0.05,
              f"PTV {label}: median ({mu}, {mv})")
        check(matched > 0.8, f"PTV {label}: matched share {matched}")
        if "frame_mask" in kw:
            inside = sum(int((np.rint(x) < FRAME[1] // 2).sum()) for x, _ in ptv.detect(frames))
            check(inside == 0 and (res.x >= FRAME[1] // 2 - 0.5).all(),
                  f"PTV {label}: {inside} detections inside the mask")
        log(f"PTV {label} ({smi}): {res.n_a} / {res.n_b} particles detected, "
            f"{len(res.x)} tracks ({matched:.4f} of frame A's), median "
            f"({mu:.4f}, {mv:.4f}) px, shift_windows launches {launches['shift_windows']}")
        tracks[label] = res
    res = tracks["guided"]
    _, _, gu, _, _ = bin_to_grid(res.x, res.y, res.u, res.v, FRAME, 64, 32)
    filled = np.isfinite(gu)
    check(filled.mean() > 0.95 and abs(np.nanmedian(gu) - DISPLACEMENT[0]) < 0.05,
          f"bin_to_grid: {filled.mean()} nodes filled, median u {np.nanmedian(gu)}")
    detect = call_times(lambda: detect_particles(frames, PTV_CAPACITY, 3, smooth_sigma=1.3))
    (dxa, dya), (dxb, dyb) = PTV(FRAME, max_particles=PTV_CAPACITY).detect(frames)
    t0 = time.perf_counter()
    match_particles(dxa, dya, dxb, dyb, radius=10.0)
    match_ms = (time.perf_counter() - t0) * 1e3
    log(f"PTV ({smi}): bin_to_grid of the guided tracks on the w64/o32 grid: "
        f"{filled.mean():.4f} of the nodes filled, median u {np.nanmedian(gu):.4f} px; "
        f"detection of both frames: {times_text(detect)}; matching {match_ms:.1f} ms "
        f"on the host clock ({len(dxa)} against {len(dxb)} particles)")


def models_quality(fa: np.ndarray, fb: np.ndarray, smi: str) -> None:
    """The quality maps on the first uniform pair at w64/o32, and the SAD
    matchers timed at the pass-1 shape."""
    from torchpiv_tpu_torch.ops.sad import fast_sad, sad_fft
    from torchpiv_tpu_torch.ops.windows import extract_windows
    from torchpiv_tpu_torch.stats import quality

    a, b = torch.from_numpy(fa).cuda(), torch.from_numpy(fb).cuda()
    snr = quality.snr_map(a, b, 64, 32)
    sx, sy = quality.peak_width_map(a, b, 64, 32)
    su, sv = quality.uncertainty_map(a, b, 64, 32)
    width = float(np.nanmedian(np.concatenate([sx.ravel(), sy.ravel()])))
    check(abs(width / PEAK_SIGMA - 1) < 0.25,
          f"peak_width_map: median {width} px against {PEAK_SIGMA}")
    check(np.isfinite(snr).all() and np.nanmedian(snr) > 1.2,
          f"snr_map: median {np.nanmedian(snr)}")
    check(np.isfinite(su).mean() > 0.95 and float(np.nanmedian(su)) < 0.5,
          f"uncertainty_map: median {np.nanmedian(su)}")
    ms = {name: call_times(lambda f=getattr(quality, name): f(a, b, 64, 32))
          for name in ("snr_map", "peak_width_map", "uncertainty_map")}
    wa, wb = extract_windows(a, 64, 32), extract_windows(b, 64, 32)
    ms["fast_sad"] = call_times(lambda: fast_sad(wa, wb))
    ms["sad_fft"] = call_times(lambda: sad_fft(wa, wb))
    log(f"quality maps ({smi}): snr median {np.nanmedian(snr):.3f}, peak width median "
        f"{width:.4f} px against {PEAK_SIGMA:.4f} implied by the particles, "
        f"uncertainty median ({np.nanmedian(su):.4f}, {np.nanmedian(sv):.4f}) px")
    for k, t in ms.items():
        log(f"{k} ({smi}) at w64/o32 on one pair ({wa.shape[0]} windows"
            f"{'; the map ends in a copy to the host' if k.endswith('map') else ''}): "
            f"{times_text(t)}")


def models_against_cpu(smi: str) -> None:
    """Each new model and map on one 1024 x 1024 pair on the card and on the
    CPU, under the tolerances of the port's CPU tests against the JAX
    package."""
    from torchpiv_tpu_torch import PIVConfig
    from torchpiv_tpu_torch.models import PTV, EnsemblePIV, FolkiPIV, MultiDtPIV
    from torchpiv_tpu_torch.stats import quality
    from torchpiv_tpu_torch.utils.synthetic import particle_pair

    S = REFERENCE_FRAME
    cfg1 = PIVConfig(frame_shape=S, wind_size=64, overlap=32, multipass=1, peakfit="pallas")
    cfg2 = PIVConfig(frame_shape=S, wind_size=64, overlap=32, multipass=2)
    gaps = {}
    A, B = sparse_batch(S, 4, 800, ENSEMBLE_DENSITY)
    got = [t.cpu() for t in EnsemblePIV(cfg1)(A, B)]
    want = EnsemblePIV(cfg1, device="cpu")(A, B)
    check(torch.equal(got[2], want[2]), "EnsemblePIV: masks differ on the card")
    gaps["EnsemblePIV"] = float(max((got[i] - want[i]).abs()[~want[2]].max() for i in (0, 1)))
    frames = moving_sequence(S, SEQ_DU, seed=801)
    g, w = MultiDtPIV(cfg2)(frames, 0), MultiDtPIV(cfg2, device="cpu")(frames, 0)
    both = ~(g.invalid | w.invalid)
    check(np.mean(g.invalid != w.invalid) < 0.02 and np.mean(g.dt_map == w.dt_map) >= 0.98,
          "MultiDtPIV: masks or dt_map differ on the card")
    gaps["MultiDtPIV"] = float(np.sqrt(np.mean((g.u - w.u)[both] ** 2)))
    fa, fb = particle_pair(S, DISPLACEMENT, seed=802)
    ha, hb = particle_pair(S, HYBRID_DISPLACEMENT, seed=803)
    for label, pc, (x, y) in (("FolkiPIV dense", None, (fa, fb)),
                              ("FolkiPIV hybrid", cfg2, (ha, hb))):
        g = FolkiPIV(S, 32, 16, piv_config=pc)(x, y)
        w = FolkiPIV(S, 32, 16, piv_config=pc, device="cpu")(x, y)
        check(np.mean(g[2] != w[2]) <= 0.02, f"{label}: bad masks differ on the card")
        gaps[label] = float(max(np.sqrt(np.mean((g[i] - w[i]) ** 2)) for i in (0, 1)))
    pa, pb = particle_pair(S, DISPLACEMENT, density=PTV_DENSITY, seed=804)
    for label, pc in (("PTV", None), ("PTV guided", cfg2)):
        g = PTV(S, piv_config=pc, max_particles=PTV_CAPACITY)(pa, pb)
        w = PTV(S, piv_config=pc, max_particles=PTV_CAPACITY, device="cpu")(pa, pb)
        gt = {(round(float(x), 3), round(float(y), 3)): (u, v)
              for x, y, u, v in zip(g.x, g.y, g.u, g.v)}
        wt = {(round(float(x), 3), round(float(y), 3)): (u, v)
              for x, y, u, v in zip(w.x, w.y, w.u, w.v)}
        common = set(gt) & set(wt)
        check((g.n_a, g.n_b) == (w.n_a, w.n_b)
              and len(common) >= 0.99 * max(len(gt), len(wt)),
              f"{label}: detections or tracks differ on the card")
        gaps[label] = float(max(max(abs(gt[k][0] - wt[k][0]), abs(gt[k][1] - wt[k][1]))
                                for k in common))
    for name in ("snr_map", "peak_width_map", "uncertainty_map"):
        g = getattr(quality, name)(fa, fb, 64, 32)
        w = getattr(quality, name)(fa, fb, 64, 32, device="cpu")
        rel = 0.0
        for gm, wm in zip(*(m if isinstance(m, tuple) else (m,) for m in (g, w))):
            check(np.array_equal(np.isnan(gm), np.isnan(wm)), f"{name}: NaN pattern differs")
            fin = np.isfinite(wm)
            rel = max(rel, float(np.max(np.abs(gm[fin] - wm[fin]) / np.abs(wm[fin]))))
        gaps[name] = rel
    # a track's u, v is the difference of two float32 positions, which are
    # resolved to 6.1e-5 px near 1024 px: 1e-4 px plus two of those steps
    track = 1e-4 + 2 * float(np.spacing(np.float32(max(S) - 1)))
    limits = {"EnsemblePIV": 1e-4, "MultiDtPIV": 0.01, "FolkiPIV dense": 1e-3,
              "FolkiPIV hybrid": 1e-3, "PTV": track, "PTV guided": track,
              "snr_map": 1e-4, "peak_width_map": 1e-4, "uncertainty_map": 1e-4}
    for k, gap in gaps.items():
        check(gap <= limits[k], f"{k}: CUDA against CPU {gap} over {limits[k]}")
    log(f"models, CUDA against CPU on one {S} pair ({smi}): "
        + ", ".join(f"{k} {gaps[k]:.3e} (limit {limits[k]})" for k in gaps)
        + " (px: max abs, RMS for MultiDtPIV and FOLKI; relative for the maps)")


def phase_models(uniform: str, kernels, smi: str) -> None:
    """Phase 11: ``EnsemblePIV``, ``MultiDtPIV``, ``FolkiPIV`` dense and
    hybrid, ``PTV`` plain, guided and masked, the quality maps and the SAD
    matchers at 2048 x 2048, then each against the CPU at 1024 x 1024."""
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    t0 = time.perf_counter()
    fa, fb = PIVDataset(uniform, ".bmp")[0]
    models_ensemble(kernels, smi)
    models_multidt(kernels, smi)
    models_folki(fa, fb, kernels, smi)
    models_ptv(kernels, smi)
    models_quality(fa, fb, smi)
    models_against_cpu(smi)
    log(f"models phase: {time.perf_counter() - t0:.1f} s")


# ---- phase 12: the command line ----------------------------------------------

def cli_call(argv) -> tuple:
    """``tpiv-torch`` in this process: ``(exit code, standard output,
    seconds)``; the output is printed too."""
    import contextlib
    import io

    from torchpiv_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    log(out.rstrip())
    return rc, out, seconds


def cli_run(folder: str, kernels, *extra) -> tuple:
    """``tpiv-torch run`` over ``folder`` at the main path's width on the
    card, every pair's text table saved; returns the tables, the launch
    counts (set to 0 just before, read just after) and the seconds."""
    from torchpiv_tpu_torch.utils.persistence import load_table, saved_series_key

    save = tempfile.mkdtemp(prefix="cli_run_", dir=os.path.dirname(folder))
    zero_counts(kernels)
    rc, _, seconds = cli_call(["run", folder, "--multipass", "2", "--device", "cuda",
                               "--batch-size", str(BATCH), "--save", "Save all text",
                               "--save-dir", save, *extra])
    launches = read_counts(kernels)
    check(rc == 0, f"tpiv-torch run {list(extra)} exited {rc}")
    files = sorted((f for f in os.listdir(save) if "_pair" in f), key=saved_series_key)
    return [load_table(os.path.join(save, f)) for f in files], launches, seconds


def check_shear_tables(tables, label: str) -> float:
    """The sheared pairs' tables: u within 0.1 px of 1 + 0.004 y (the rows
    are flipped to y-up, the coordinates are not), mean v under 0.05 px."""
    worst = 0.0
    for t in tables:
        want = SHEAR[0] + SHEAR[1] * t["y[mm]"][2:-2, 2:-2]
        mae = float(np.abs(np.flip(t["Vx[m/s]"], axis=0)[2:-2, 2:-2] / UNIT - want).mean())
        mv = float(t["Vy[m/s]"][2:-2, 2:-2].mean() / UNIT)
        check(mae < 0.1 and abs(mv) < 0.05, f"{label}: shear error {mae} px, mean v {mv}")
        worst = max(worst, mae)
    return worst


def phase_cli(uniform: str, shear: str, tmp: str, kernels, cws_fields, smi: str) -> dict:
    """Phase 12: ``tpiv-torch`` at the main path's full width on the card:
    ``run`` in this process (its per-pair tables equal to phase 4's fields
    at the saved precision) and in a fresh interpreter (the cold start),
    ``run`` with DEF and with bicubic CWS, ``warmup``, ``doctor --cache``,
    ``qc``, ``ensemble`` and a cut ``bench``.  Returns the CLI's launch
    counts of rows 1-3 and the readings."""
    os.environ["TORCHPIV_TPU_CONFIG_DIR"] = os.path.join(tmp, "cli_settings")
    t_phase = time.perf_counter()
    readings = {}
    tables, launches, readings["run_s"] = cli_run(uniform, kernels)
    check(launches == only(launches, shift_windows=2 * N_PAIRS // BATCH),
          f"tpiv-torch run launches {launches}")
    check(len(tables) == N_PAIRS, f"tpiv-torch run saved {len(tables)} tables")
    worst = 0.0
    for t, field in zip(tables, cws_fields):
        for key, want in zip(("x[mm]", "y[mm]", "Vx[m/s]", "Vy[m/s]"), field):
            worst = max(worst, float(np.abs(t[key] - want).max()))
    check(worst < 6e-7, f"tpiv-torch run: tables differ from phase 4's fields by {worst}")
    cli_launches = {"shift_windows": launches["shift_windows"]}
    log(f"tpiv-torch run ({smi}): {N_PAIRS} pairs in {readings['run_s']:.3f} s in this "
        f"process, per-pair tables within {worst:.1e} of phase 4's fields, "
        f"launches {launches}")

    # the cold start: a fresh interpreter, import and kernel loading included
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "torchpiv_tpu_torch.cli", "run", uniform,
                        "--multipass", "2", "--device", "cuda", "--save", "Dont save"],
                       env=env, capture_output=True, text=True, timeout=600)
    readings["fresh_run_s"] = time.perf_counter() - t0
    check(r.returncode == 0, f"python -m torchpiv_tpu_torch.cli run exited "
                             f"{r.returncode}: {r.stderr[-2000:]}")
    log(f"python -m torchpiv_tpu_torch.cli run ({smi}): exit 0 in "
        f"{readings['fresh_run_s']:.3f} s of wall time, a fresh interpreter with "
        f"import and kernel loading")

    tables, launches, readings["def_s"] = cli_run(shear, kernels, "--multipass-mode", "DEF")
    check(launches == only(launches, def_windows=2 * N_SHEAR_PAIRS // BATCH),
          f"tpiv-torch run DEF launches {launches}")
    mae = check_shear_tables(tables, "tpiv-torch run DEF")
    cli_launches["def_windows"] = launches["def_windows"]
    log(f"tpiv-torch run --multipass-mode DEF ({smi}): {len(tables)} sheared pairs in "
        f"{readings['def_s']:.3f} s, worst mean |u - shear| {mae:.4f} px, "
        f"launches {launches}")
    one_batch = os.path.join(tmp, "cli_shear_batch")
    os.makedirs(one_batch)
    for name in sorted(os.listdir(shear))[:2 * BATCH]:
        os.link(os.path.join(shear, name), os.path.join(one_batch, name))
    tables, launches, readings["bicubic_s"] = cli_run(one_batch, kernels,
                                                      "--cws-interp", "bicubic")
    check(launches == only(launches, shift_windows_bicubic=2),
          f"tpiv-torch run bicubic launches {launches}")
    mae = check_shear_tables(tables, "tpiv-torch run bicubic")
    cli_launches["shift_windows_bicubic"] = launches["shift_windows_bicubic"]
    log(f"tpiv-torch run --cws-interp bicubic ({smi}): one batch of {len(tables)} in "
        f"{readings['bicubic_s']:.3f} s, worst mean |u - shear| {mae:.4f} px, "
        f"launches {launches}")

    rc, _, readings["warmup_s"] = cli_call(["warmup", "2048x2048", "--multipass", "2"])
    check(rc == 0, f"tpiv-torch warmup exited {rc}")
    log(f"tpiv-torch warmup 2048x2048 --multipass 2 ({smi}): {readings['warmup_s']:.3f} s")

    rc, out, readings["doctor_s"] = cli_call(["doctor", "--cache"])
    check(rc == 0 and "8/8 checks passed" in out, f"tpiv-torch doctor exited {rc}")
    (trip,) = [ln for ln in out.splitlines() if "cache round-trip" in ln]
    check("libfastio-" in trip and "libshift_windows-" in trip
          and "second: loaded from disk (wrote 0)" in trip,
          f"doctor's build-cache round trip: {trip}")
    log(f"tpiv-torch doctor --cache ({smi}): 8/8 checks in {readings['doctor_s']:.3f} s")

    rc, _, readings["qc_s"] = cli_call(["qc", uniform, "--pairs", "2"])
    check(rc == 0, f"tpiv-torch qc exited {rc}")
    ens_out = os.path.join(tmp, "cli_ensemble")
    rc, _, readings["ensemble_s"] = cli_call(["ensemble", uniform, "--wind-size", "64",
                                              "--overlap", "32", "--out", ens_out])
    check(rc == 0, f"tpiv-torch ensemble exited {rc}")
    from torchpiv_tpu_torch.utils.persistence import load_table

    field = load_table(os.path.join(ens_out, "ensemble_field.txt"))
    mu = float(field["Vx[m/s]"][2:-2, 2:-2].mean() / UNIT)
    mv = float(-field["Vy[m/s]"][2:-2, 2:-2].mean() / UNIT)
    check(abs(mu - DISPLACEMENT[0]) < 0.05 and abs(mv - DISPLACEMENT[1]) < 0.05,
          f"tpiv-torch ensemble: mean displacement ({mu}, {mv})")
    log(f"tpiv-torch qc over 2 pairs ({smi}): {readings['qc_s']:.3f} s; ensemble over "
        f"{N_PAIRS}: {readings['ensemble_s']:.3f} s, mean displacement "
        f"({mu:.4f}, {mv:.4f}) px")

    saved = {k: os.environ.get(k) for k in ("BENCH_PAIRS", "BENCH_REPEATS")}
    os.environ.update(BENCH_PAIRS="16", BENCH_REPEATS="2")
    try:
        rc, out, readings["bench_s"] = cli_call(["bench"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    check(rc == 0, f"tpiv-torch bench exited {rc}")
    bench = json.loads(out.strip().splitlines()[-1])
    check(bench["metric"] == "4MP_pairs_per_sec" and bench["value"] > 0
          and bench["device"]["kind"] == torch.cuda.get_device_name(0),
          f"tpiv-torch bench printed {bench}")
    log(f"bench (BENCH_PAIRS=16 BENCH_REPEATS=2, no claim): {json.dumps(bench)}")
    readings["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"cli_launches": cli_launches, "cli_seconds": readings, "card": smi}))
    return cli_launches


def video_stand_in(videos: dict):
    """A stand-in for OpenCV's ``cv2`` module where the card's machine has
    none: ``VideoCapture(path)`` over the decoded ``[H, W]`` uint8 frames
    ``videos[path]``, with ``isOpened``, ``get``, ``read`` and ``release``
    and the three ``CAP_PROP_*`` constants ``io.video`` reads."""
    import types

    class VideoCapture:
        def __init__(self, path):
            self._frames = videos.get(path)
            self._next = 0

        def isOpened(self):  # noqa: N802 (the OpenCV name)
            return self._frames is not None

        def get(self, prop):
            if prop == stand_in.CAP_PROP_FRAME_COUNT:
                return float(len(self._frames))
            h, w = self._frames[0].shape
            return float(h if prop == stand_in.CAP_PROP_FRAME_HEIGHT else w)

        def read(self):
            if self._next >= len(self._frames):
                return False, None
            self._next += 1
            return True, self._frames[self._next - 1].copy()

        def release(self):
            self._frames = None

    stand_in = types.SimpleNamespace(
        VideoCapture=VideoCapture, CAP_PROP_FRAME_COUNT=7,
        CAP_PROP_FRAME_HEIGHT=4, CAP_PROP_FRAME_WIDTH=3)
    return stand_in


# ---- phase 13: the XLA-semantics resampling paths ----------------------------

# (a): the headline path with use_pallas="off"; the launches a batch of each
# run (every other count 0): rows 1-3 none, row 5 once a pass under split,
# row 4 once a pass under peakfit="pallas"
OFF_PATHS = (("CWS", "uniform", {}, {}),
             ("DWS", "uniform", {"multipass_mode": "DWS"}, {}),
             ("DEF", "shear", {"multipass_mode": "DEF"}, {}),
             ("CWS bicubic", "uniform", {"cws_interp": "bicubic"}, {}),
             ("CWS fused=split", "uniform", {"fused": "split"}, {"correlate_peakfit": 2}),
             ("CWS peakfit=pallas", "uniform", {"peakfit": "pallas"}, {"peakfit": 2}))
# (b): windows beyond the kernels' limits at "auto", and the limit cases:
# (label, folder, OfflinePIV keywords, launches a batch, pairs: None = all)
LIMIT_PATHS = (
    ("DEF w256/o128", "shear",
     dict(wind_size=256, overlap=128, multipass_mode="DEF"), {}, None),
    ("CWS bicubic w256/o128", "uniform",
     dict(wind_size=256, overlap=128, engine_options={"cws_interp": "bicubic"}),
     {}, None),
    ("CWS w512/o256 x3", "uniform", dict(wind_size=512, overlap=256, multipass=3),
     {"shift_windows": 2}, None),
    ("CWS bicubic w250/o124 (125 px)", "uniform",
     dict(wind_size=250, overlap=124, engine_options={"cws_interp": "bicubic"}),
     {"shift_windows_bicubic": 2}, BATCH),
    ("DEF w248/o124 (129 px tile)", "shear",
     dict(wind_size=248, overlap=124, multipass_mode="DEF"), {"def_windows": 2}, BATCH))
# (c): the camera-degraded campaign of tools/degraded_campaign_cuda.py (its
# tiers, pairs, settings and metrics) at the main path's frame
CAMPAIGN_TOOL = "tools/degraded_campaign_cuda.py"
N_DEGRADED = 6  # pairs a tier
CAMPAIGN_MODES = (("SCC", "off", {}), ("RPC", "off", {"correlation": "rpc"}),
                  ("fallback", "off", {"second_peak_fallback": True}),
                  ("SCC", "auto", {}))


def field_difference(engine_a, engine_b, a, b) -> tuple:
    """Mask mismatch and RMS px on jointly valid vectors of two engines on
    the same batch."""
    ua, va, ia = (t.cpu().numpy() for t in engine_a(a, b))
    ub, vb, ib = (t.cpu().numpy() for t in engine_b(a, b))
    both = ~(ia | ib)
    d = np.concatenate([(ua - ub)[both], (va - vb)[both]]).astype(np.float64)
    return float((ia != ib).mean()), float(np.sqrt(np.mean(d ** 2)))


def phase_xla_off(folders: dict, kernels, kernel_profiles: dict, smi: str) -> None:
    """Phase 13 (a): the headline path with ``use_pallas="off"``."""
    from torchpiv_tpu_torch import MultipassPIV, OfflinePIV, PIVConfig
    from torchpiv_tpu_torch.io.dataset import PIVDataset

    n_batches = -(-N_PAIRS // BATCH)
    for label, which, knobs, per_batch in OFF_PATHS:
        folder = folders[which]
        mode = knobs.get("multipass_mode", "CWS")
        options = {k: v for k, v in knobs.items() if k != "multipass_mode"}
        piv = OfflinePIV(folder, wind_size=64, overlap=32, multipass=2,
                         multipass_mode=mode, batch_size=BATCH,
                         engine_options={"use_pallas": "off", **options})
        check(piv.engine.device.type == "cuda" and piv.engine.config.use_pallas == "off",
              f"{label} off: the knob did not reach an engine on the card")
        valid = warm_up(piv, folder)
        check(valid > 0.95, f"{label} off: valid share {valid}")
        fields, launches, pairs_per_s = drive(piv, kernels)
        check_fields(fields, piv, N_PAIRS)
        want = {k: n * n_batches for k, n in per_batch.items()}
        check(launches == only(launches, **want), f"{label} off: launches {launches}")
        if which == "shear":
            mae = shear_error(fields, piv)
            log(f"{label} off: worst mean |u - shear| {mae:.4f} px")
            check(mae < 0.1, f"{label} off: shear error {mae}")
        else:
            # DWS refines a whole-pixel offset: its fit of the 0.7 px residual
            # locks towards the integer, so its mean u reads about 0.07 px high
            check_displacement(fields, f"{label} off", 0.1 if mode == "DWS" else 0.05)
        _, a, b = PIVDataset(folder, ".bmp").read_batch(list(range(BATCH)))
        a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        auto = MultipassPIV(dataclasses.replace(piv.engine.config, use_pallas="auto"))
        flips, rms = field_difference(piv.engine, auto, a, b)
        del a, b, auto
        log(f"{label} off: {len(fields)} pairs at {pairs_per_s:.3f} pairs/s, valid "
            f"share {valid:.4f}, launches {launches}; against use_pallas=auto on the "
            f"first batch: mask mismatch {flips:.5f}, RMS {rms:.3e} px")
        prof = phase_profile(folder, f"{label} use_pallas=off", use_pallas="off", **knobs)
        kp = kernel_profiles.get(label)
        beside = ("" if kp is None else
                  f"; the kernel path (phase 7): {kp['device_ms']:.3f} ms of device "
                  f"time, peak {kp['peak_bytes'] / 2**20:.1f} MiB")
        log(f"{label} use_pallas=off: {prof['device_ms']:.3f} ms of device time a "
            f"batch of {BATCH}, engine {prof['ms_batch']:.3f} ms, peak device memory "
            f"{prof['peak_bytes'] / 2**20:.1f} MiB{beside} ({smi})")
        phase_reference(folder, f"{label} use_pallas=off", use_pallas="off", **knobs)
        torch.cuda.empty_cache()


def phase_beyond_limits(folders: dict, kernels) -> None:
    """Phase 13 (b): windows beyond the kernels' limits at ``"auto"`` take
    the XLA paths (their kernels never launch), the limit cases launch
    theirs."""
    from torchpiv_tpu_torch import OfflinePIV

    for label, which, kw, per_batch, n_pairs in LIMIT_PATHS:
        kw = {"multipass": 2, **kw}
        piv = OfflinePIV(folders[which], batch_size=BATCH, max_pairs=n_pairs, **kw)
        n_pairs = n_pairs or (N_SHEAR_PAIRS if which == "shear" else N_PAIRS)
        fields, launches, pairs_per_s = drive(piv, kernels)
        check_fields(fields, piv, n_pairs)
        n_batches = -(-n_pairs // BATCH)
        want = {k: n * n_batches for k, n in per_batch.items()}
        check(launches == only(launches, **want), f"{label}: launches {launches}")
        if which == "shear":
            mae = shear_error(fields, piv)
            log(f"{label}: worst mean |u - shear| {mae:.4f} px")
            check(mae < 0.1, f"{label}: shear error {mae}")
        else:
            check_displacement(fields, label)
        log(f"{label}: passes {piv.engine.schedule}, {len(fields)} pairs at "
            f"{pairs_per_s:.3f} pairs/s, launches {launches}")
        torch.cuda.empty_cache()


def phase_degraded(tmp: str, kernels, smi: str) -> None:
    """Phase 13 (c): the camera-degraded campaign at the main path's frame,
    through the functions of ``tools/degraded_campaign_cuda.py``."""
    campaign = load_tool(CAMPAIGN_TOOL)
    t0 = time.perf_counter()
    tiers = {}
    for tier in campaign.TIERS:
        tiers[tier] = os.path.join(tmp, f"degraded_{tier}")
        campaign.make_dataset(tiers[tier], FRAME[0], N_DEGRADED, tier)
    log(f"wrote {N_DEGRADED} pairs a tier of {FRAME} in {time.perf_counter() - t0:.1f} s")
    table = {}
    for tier, folder in tiers.items():
        for mode, pallas, options in CAMPAIGN_MODES:
            label = f"{tier} {mode} use_pallas={pallas}"
            piv = campaign.offline(folder, "cuda", pallas, engine_options=options,
                                   batch_size=BATCH)
            fields, launches, _ = drive(piv, kernels)
            table[label] = campaign.field_metrics(fields)
            log(json.dumps({"campaign": label, **table[label], "launches": launches,
                            "card": smi}))
    moderate = table["moderate SCC use_pallas=off"]
    check(moderate["pairs_yielded"] == N_DEGRADED and moderate["bad_pct"] < 1.0
          and moderate["rms_good_px"] < 0.3, f"moderate SCC: {moderate}")
    scc = table["harsh SCC use_pallas=off"]["pairs_yielded"]
    for mode in ("RPC", "fallback"):
        got = table[f"harsh {mode} use_pallas=off"]["pairs_yielded"]
        check(got > scc, f"harsh {mode} yields {got} pairs, SCC {scc}")
    phase_reference(tiers["harsh"], "harsh SCC use_pallas=off", use_pallas="off")


def phase_xla_paths(uniform: str, shear: str, tmp: str, kernels, kernel_profiles: dict,
                    smi: str) -> None:
    """Phase 13: the JAX engine's XLA resampling paths at the main path's
    frame on the card."""
    t0 = time.perf_counter()
    folders = {"uniform": uniform, "shear": shear}
    phase_xla_off(folders, kernels, kernel_profiles, smi)
    log(f"phase 13 (a) done at {time.perf_counter() - t0:.1f} s")
    phase_beyond_limits(folders, kernels)
    log(f"phase 13 (b) done at {time.perf_counter() - t0:.1f} s")
    phase_degraded(tmp, kernels, smi)
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")


# ---- phase 14: the scripts beside the package ---------------------------------

# the engines whose resampling kernels store bfloat16 windows (phase 8)
BF16_STORE_PATHS = (("CWS", "uniform", {}), ("DWS", "uniform", {"multipass_mode": "DWS"}),
                    ("DEF", "shear", {"multipass_mode": "DEF"}),
                    ("CWS bicubic", "shear", {"cws_interp": "bicubic"}),
                    ("DEF fused=split", "shear", {"multipass_mode": "DEF", "fused": "split"}))
SUSTAINED_TOOL = "tools/sustained_run_cuda.py"
COLDSTART_TOOL = "tools/coldstart_cuda.py"
ACCURACY_TOOL = "tools/accuracy_table_cuda.py"
EXAMPLES = ("demo", "postprocess_demo", "dense_demo", "tracking_pressure_demo",
            "sharded_demo")
BIAS_BUDGET = 0.05  # px: tests/test_accuracy_modes.py, the peak-locking pin
COLDSTART_PARTS = ("imports_s", "card_init_s", "decoder_load_s", "engine_build_s",
                   "first_batch_s")


def scripts_sustained(kernels, smi: str) -> None:
    """The sustained run at its defaults (4,000 pairs of 2048x2048, batch 8):
    every repeat of a unique pair gives that pair's first digest (a hash of
    its ``u, v`` bytes, taken inside the timed loop), and each unique pair's
    interior mean lies within 0.05 px of the displacement."""
    import hashlib

    tool = load_tool(SUSTAINED_TOOL)
    s = tool.settings()
    digests, means, differing = {}, {}, []

    def on_field(k, i, field):
        check(field is not None, f"sustained run: pair {k} was skipped")
        _, _, u, v = field
        d = hashlib.blake2b(u.tobytes() + v.tobytes(), digest_size=16).digest()
        if digests.setdefault(i, d) != d:
            differing.append(k)
        if i not in means:
            check(np.isfinite(u).all() and np.isfinite(v).all(), "sustained: non-finite")
            means[i] = (float(u[2:-2, 2:-2].mean()) / UNIT,
                        -float(v[2:-2, 2:-2].mean()) / UNIT)

    zero_counts(kernels)
    out = tool.run(torch.device("cuda"), frame=tool.FRAME, on_field=on_field, **s)
    launches = read_counts(kernels)
    n_dispatches = -(-s["n_pairs"] // s["batch"])
    check(out["n_pairs"] == s["n_pairs"] == 4000 and tool.FRAME == FRAME,
          f"sustained run: {out['n_pairs']} pairs of {tool.FRAME}")
    check(not differing, f"sustained run: {len(differing)} pairs differ from their "
                         f"unique pair's first field, the first {differing[:5]}")
    check(len(digests) == s["n_unique"], f"sustained run: {len(digests)} unique pairs")
    for i, (mu, mv) in means.items():
        check(abs(mu - DISPLACEMENT[0]) < 0.05 and abs(mv - DISPLACEMENT[1]) < 0.05,
              f"sustained run: unique pair {i} mean ({mu}, {mv})")
    # the excluded first batch and every timed dispatch: row 1 twice a call
    check(launches == only(launches, shift_windows=2 * (n_dispatches + 1)),
          f"sustained run: launches {launches}")
    log(json.dumps({"metric": out["metric"], "value": out["value"], "unit": "s",
                    "pairs_per_sec": out["pairs_per_sec"], "n_pairs": out["n_pairs"],
                    "batch": s["batch"], "compile_first_batch_s":
                    out["compile_first_batch_s"], "checkpoints": out["checkpoints"],
                    "launches": launches, "unique_means_px": means, "card": smi}))


def coldstart_run(folder: str, cache_dir, label: str) -> dict:
    """``tools/coldstart_cuda.py`` in a fresh interpreter over ``folder``,
    with ``TORCHPIV_CACHE_DIR`` set to ``cache_dir`` (None: this process's
    build cache); returns its JSON line with the process's wall seconds."""
    env = dict(os.environ)
    if cache_dir is not None:
        env["TORCHPIV_CACHE_DIR"] = cache_dir
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                      COLDSTART_TOOL), "--folder", folder],
        env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cold start {label}: exit {proc.returncode}\n"
                                f"{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    parts = out["parts"]
    check(all(parts[k] >= 0 for k in COLDSTART_PARTS)
          and sum(parts[k] for k in COLDSTART_PARTS) <= out["value"] + 1e-3
          and out["value"] <= out["total_s"] and out["n_pairs"] == 48,
          f"cold start {label}: {out}")
    # the kernels load lazily, inside the engine build and the first batch,
    # and a 2-pass CWS engine launches row 1 alone
    check(list(out["kernel_loads"]) == ["shift_windows"]
          and out["kernel_load_s"] <= parts["engine_build_s"] + parts["first_batch_s"] + 1e-3,
          f"cold start {label}: kernels {out['kernel_loads']}")
    out["process_wall_s"] = wall
    log(json.dumps({"coldstart": label, **out}))
    return out


def scripts_coldstart(tmp: str) -> None:
    """Time to first field in fresh interpreters: warm (the build cache of
    phase 2), with an empty ``TORCHPIV_CACHE_DIR`` (``nvcc`` builds the
    kernel the engine launches, ``g++`` the decoder, as on a user's first
    run) and warm again.  The first call makes the folder (4 generated
    pairs, 44 hard links), which its timing excludes."""
    folder = os.path.join(tmp, "coldstart_pairs")
    empty = os.path.join(tmp, "coldstart_cache")
    warm = coldstart_run(folder, None, "warm")
    cold = coldstart_run(folder, empty, "empty cache")
    again = coldstart_run(folder, None, "warm again")
    built = sorted(b.split("-")[0] for b in os.listdir(empty) if b.endswith(".so"))
    check(built == ["libfastio", "libshift_windows"]
          and cold["kernel_loads"]["shift_windows"]["built"]
          and not warm["kernel_loads"]["shift_windows"]["built"]
          and not again["kernel_loads"]["shift_windows"]["built"],
          f"cold start: the empty cache holds {os.listdir(empty)}")
    log(f"cold start: time to first field {warm['value']:.3f} / {again['value']:.3f} s "
        f"warm, {cold['value']:.3f} s with an empty cache (row 1's load "
        f"{cold['kernel_load_s']:.3f} s against {warm['kernel_load_s']:.3f}, the decoder's "
        f"{cold['parts']['decoder_load_s']:.3f} against "
        f"{warm['parts']['decoder_load_s']:.3f}); processes {warm['process_wall_s']:.2f} / "
        f"{cold['process_wall_s']:.2f} / {again['process_wall_s']:.2f} s")


def scripts_accuracy(kernels, smi: str) -> None:
    """The accuracy table and its three sections on the card at
    ``use_pallas="auto"`` (rows 1-3): every cell finite, max |bias| over the
    sweep under the budget of ``tests/test_accuracy_modes.py``, DEF below
    CWS on the shear for each resampling and fit."""
    tool = load_tool(ACCURACY_TOOL)
    run = tool.Runner(torch.device("cuda"), "auto")
    zero_counts(kernels)
    res = tool.eval_table(run)
    launches = read_counts(kernels)
    log(f"accuracy table ({smi}):\n{tool.HEADER}\n"
        + "\n".join(tool.table_row(n, m) for n, m in res.items()))
    for name, m in res.items():
        check(all(np.isfinite(x) for x in m.values()), f"accuracy {name}: {m}")
        check(m["pk_bias"] < BIAS_BUDGET, f"accuracy {name}: peak locking {m['pk_bias']}")
        if name.startswith("DEF/"):
            cws = res["CWS/" + name[4:]]
            check(m["sh_rms"] < cws["sh_rms"],
                  f"accuracy {name}: shear RMS {m['sh_rms']} not below CWS {cws['sh_rms']}")
    check(all(launches[k] > 0 for k in ("shift_windows", "shift_windows_bicubic",
                                        "def_windows")),
          f"accuracy table: launches {launches}")
    log(f"accuracy table: launches {launches}")
    log(tool.smoothing_text(tool.CONFIGS[0][0], tool.eval_smoothing(run, tool.CONFIGS[0][1])))
    log(tool.rpc_text(tool.eval_rpc(run)))
    tot, glare = tool.eval_rescue(run)
    log(tool.rescue_text(tot, glare))
    check(glare["rescued"] == 0, f"rescue: the glare blob was rescued: {glare}")


def fields_within(got, want, label: str) -> tuple:
    """Two ``(u, v, invalid)`` stacks within the parity budget: mask
    mismatch < 2%, RMS < 0.01 px on jointly valid vectors; returns both."""
    (gu, gv, gi), (wu, wv, wi) = got, want
    both = ~(gi | wi)
    flips = float(np.mean(gi != wi))
    d = np.concatenate([(gu - wu)[both], (gv - wv)[both]]).astype(np.float64)
    rms = float(np.sqrt(np.mean(d ** 2))) if d.size else 0.0
    check(flips < 0.02 and rms < 0.01, f"{label}: mask mismatch {flips}, RMS {rms}")
    return flips, rms


def example_gaps(name: str, ex, card: dict, cpu: dict) -> str:
    """The card's run of example ``name`` against its CPU run, gated."""
    if name == "demo":
        t, w = card["table"], cpu["table"]
        check(np.array_equal(t["x[mm]"], w["x[mm]"]) and card["pairs"] == cpu["pairs"],
              "demo: grids or pair counts differ")
        px = 1000.0 * 0.05 / 2.0  # m/s a px at the demo's scale and dt
        d = np.concatenate([(t[k] - w[k]).ravel() for k in ("Vx[m/s]", "Vy[m/s]")]) / px
        rms = float(np.sqrt(np.mean(d ** 2)))
        check(rms < 0.01 and np.mean(np.abs(d) > 0.01) < 0.02, f"demo: RMS {rms} px")
        return (f"pairs {card['pairs']}, peak |V| {card['peak_speed']:.4f} m/s (CPU "
                f"{cpu['peak_speed']:.4f}); mean fields RMS {rms:.3e} px")
    if name == "postprocess_demo":
        worst = max(fields_within(g, w, f"postprocess snapshot {i}")[1]
                    for i, (g, w) in enumerate(zip(card["raw"], cpu["raw"])))
        rel = abs(card["median_uncertainty"] - cpu["median_uncertainty"]) / abs(
            cpu["median_uncertainty"])
        check(rel < 1e-4, f"postprocess: median uncertainty {rel} relative")
        return (f"median uncertainty {card['median_uncertainty']:.5f} px (CPU "
                f"{cpu['median_uncertainty']:.5f}), POD mode-0 energy "
                f"{card['pod_energy0']:.4f} (CPU {cpu['pod_energy0']:.4f}); snapshots' "
                f"worst RMS {worst:.3e} px")
    if name == "dense_demo":
        worst = 0.0
        for field in ex.NAMES:
            (gu, gok), (wu, wok) = card["fields"][field], cpu["fields"][field]
            both = gok & wok
            check(np.mean(gok != wok) < 0.02, f"dense {field}: masks differ")
            worst = max(worst, float(np.sqrt(np.mean((gu - wu)[both] ** 2))))
        check(worst < 0.01, f"dense: RMS {worst}")
        return ("u-error RMS " + ", ".join(f"{f} {card['rms'][f]:.5f} (CPU "
                                           f"{cpu['rms'][f]:.5f})" for f in ex.NAMES)
                + f" px; fields' worst RMS {worst:.3e} px")
    if name == "tracking_pressure_demo":
        g, w = card["res"], cpu["res"]
        gt = {(round(float(x), 3), round(float(y), 3)): (u, v)
              for x, y, u, v in zip(g.x, g.y, g.u, g.v)}
        wt = {(round(float(x), 3), round(float(y), 3)): (u, v)
              for x, y, u, v in zip(w.x, w.y, w.u, w.v)}
        common = set(gt) & set(wt)
        track = 1e-4 + 2 * float(np.spacing(np.float32(511)))  # phase 11's gate
        gap = max((max(abs(gt[k][0] - wt[k][0]), abs(gt[k][1] - wt[k][1]))
                   for k in common), default=0.0)
        check((g.n_a, g.n_b) == (w.n_a, w.n_b)
              and len(common) >= 0.99 * max(len(gt), len(wt)) and gap <= track,
              f"PTV demo: detections or tracks differ on the card (gap {gap})")
        check(card["core"] == cpu["core"], f"PTV demo: core {card['core']} {cpu['core']}")
        return (f"{g.n_a} particles detected, {len(g.x)} tracked (CPU {len(w.x)}), "
                f"largest track gap {gap:.3e} px; Gamma1 core {card['core']}, "
                f"|Gamma1| {card['gamma1_core']:.4f} (CPU {cpu['gamma1_core']:.4f}), "
                f"pressure at core {card['p_core']:.5g} (CPU {cpu['p_core']:.5g})")
    _, rms = fields_within((card["u"], card["v"], card["invalid"]),
                           (cpu["u"], cpu["v"], cpu["invalid"]), "sharded demo")
    means = [float(card["u"][i][~card["invalid"][i]].mean())
             for i in range(len(card["true_u"]))]
    return (f"mesh {dict(card['mesh'].shape)} over {card['devices']}; mean u "
            + ", ".join(f"{m:+.4f} (true {t:+.1f})" for m, t in zip(means, card["true_u"]))
            + f"; RMS against the CPU {rms:.3e} px")


def example_run(name: str, ex, device, out_dir: str) -> dict:
    """``run`` of example ``name`` on ``device``."""
    if name == "demo":
        return ex.run(out_dir, device)
    if name == "sharded_demo":
        return ex.run(device, 2)
    return ex.run(device)


def scripts_examples(tmp: str, kernels, smi: str) -> None:
    """Each example through ``main`` on the card (its printed lines and,
    where matplotlib is installed, its figure), then its ``run`` on the card
    and on the CPU, within the parity budget (PTV: phase 11's gates)."""
    for name in EXAMPLES:
        ex = load_tool(f"examples/{name}_cuda.py")
        out_dir = os.path.join(tmp, f"example_{name}")
        t0 = time.perf_counter()
        argv = ["--devices", "2"] if name == "sharded_demo" else [out_dir + "_main"]
        zero_counts(kernels)
        rc = ex.main(argv)
        launches = read_counts(kernels)
        main_s = time.perf_counter() - t0
        check(rc == 0 and launches["shift_windows"] > 0,
              f"{name}: exit {rc}, launches {launches}")
        t0 = time.perf_counter()
        card = example_run(name, ex, torch.device("cuda"), out_dir + "_card")
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = example_run(name, ex, torch.device("cpu"), out_dir + "_cpu")
        cpu_s = time.perf_counter() - t0
        log(f"example {name} ({smi}): main {main_s:.2f} s, run {card_s:.2f} s on the "
            f"card, {cpu_s:.2f} s on the CPU; row 1 launches in main "
            f"{launches['shift_windows']}; {example_gaps(name, ex, card, cpu)}")
    figures = sorted(f for d in os.listdir(tmp) if d.startswith("example_")
                     for f in os.listdir(os.path.join(tmp, d)) if f.endswith(".png"))
    log(f"examples: figures drawn: {figures or 'none (no matplotlib)'}")


def scripts_campaign(kernels, smi: str) -> None:
    """The campaign tool at its defaults (512x512, 6 pairs), both tiers;
    moderate SCC yields every pair with bad < 1% and RMS(good) < 0.3 px."""
    tool = load_tool(CAMPAIGN_TOOL)
    for tier in tool.TIERS:
        zero_counts(kernels)
        rows = tool.campaign(tier, 512, 6, "cuda")
        launches = read_counts(kernels)
        log(f"campaign {tier}, 512x512, 6 pairs ({smi}); launches {launches}:\n"
            + tool.table(rows))
        check(launches["shift_windows"] > 0, f"campaign {tier}: launches {launches}")
        if tier == "moderate":
            scc = rows["tpiv SCC (same settings)"]
            check(scc["pairs_yielded"] == 6 and scc["bad_pct"] < 1.0
                  and scc["rms_good_px"] < 0.3, f"campaign moderate SCC: {scc}")


def phase_scripts(tmp: str, kernels, smi: str) -> None:
    """Phase 14: the user-facing scripts beside the package on the card."""
    t0 = time.perf_counter()
    scripts_sustained(kernels, smi)
    log(f"phase 14 sustained run done at {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    scripts_coldstart(tmp)
    log(f"phase 14 cold start done at {time.perf_counter() - t0:.1f} s")
    scripts_accuracy(kernels, smi)
    log(f"phase 14 accuracy table done at {time.perf_counter() - t0:.1f} s")
    scripts_examples(tmp, kernels, smi)
    log(f"phase 14 examples done at {time.perf_counter() - t0:.1f} s")
    scripts_campaign(kernels, smi)
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s")


SWEEP_TOOL = "tools/bench_sweep_cuda.py"
AB_TOOL = "tools/bench_engine_ab_cuda.py"
PROFILE_TOOL = "tools/profile_engine_cuda.py"
AB_PAIRS = (("off", "split"), ("auto", "correlator=matmul,dft_precision=default"))
PROFILE_SHARE = 0.10  # grouped device ms against the CUDA events' ms


def phase_tools(kernels, smi: str) -> None:
    """Phase 15: the per-configuration sweep, the settings A/B and the op
    attribution (``tools/{bench_sweep,bench_engine_ab,profile_engine}_cuda.py``)
    at full width with cut repetitions, on one set of 4 unique pairs."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sweep, ab, prof = (load_tool(p) for p in (SWEEP_TOOL, AB_TOOL, PROFILE_TOOL))
    pairs = sweep.unique_pairs(FRAME)
    log(f"phase 15: 4 unique pairs of {FRAME} in {time.perf_counter() - t0:.1f} s")

    zero_counts(kernels)
    rows = sweep.sweep_configs(dev, sweep.CONFIGS, sweep.BATCH, 2, FRAME, pairs)
    launches = read_counts(kernels)
    failed = [r["label"] for r in rows if "error" in r]
    check(not failed, f"sweep: FAILED {failed}")
    for r in rows:
        check(r["grid"] == r["final_field_shape"],
              f"sweep {r['label']}: grid {r['grid']} != {r['final_field_shape']}")
    check(launches["shift_windows"] > 0 and launches["def_windows"] > 0,
          f"sweep: launches {launches}")
    headline_grid = next(r["final_field_shape"] for r in rows
                         if r["label"] == "w64 o32 2xCWS")
    log(f"sweep ({smi}), batch {sweep.BATCH}, medians of 2; launches {launches}:\n"
        + sweep.config_table(rows) + "\n" + "\n".join(
            f"sweep {r['label']}: compile+first {r['compile_first_s']:.2f} s, kernels "
            f"loaded {sorted(r['kernel_loads'])}" for r in rows))
    batches = sweep.sweep_batches(dev, sweep.BATCHES, 2, FRAME, pairs)
    log(f"sweep batches ({smi}), w64/o32 2xCWS, medians of 2:\n"
        "| scan batch | ms/pair | pairs/s |\n|---|---|---|\n" + "\n".join(
            f"| {r['batch']} | {r['ms_pair']:.2f} | {r['pairs_s']:.1f} |" for r in batches))
    torch.cuda.empty_cache()
    log(f"phase 15 sweep done at {time.perf_counter() - t0:.1f} s")

    for settings in AB_PAIRS:
        zero_counts(kernels)
        out = ab.ab(list(settings), dev, FRAME, ab.BATCH, "CWS", pairs)
        launches = read_counts(kernels)
        agreed = out["agreement"]
        log(f"A/B {settings[0]} vs {settings[1]} ({smi}), batch {ab.BATCH}, best of 3: "
            + ", ".join(f"{r['setting']} {r['ms_pair']:.3f} ms/pair" for r in out["runs"])
            + f"; {json.dumps(agreed)}; launches {launches}")
        check(agreed["mask_agree"] >= 0.98 and agreed["du_rms"] < 0.01
              and agreed["dv_rms"] < 0.01, f"A/B {settings}: {agreed}")
        check(all(r["fields"][0].shape[-2:] == r["final_field_shape"] for r in out["runs"]),
              f"A/B {settings}: grids")
        check(launches["shift_windows"] > 0, f"A/B {settings}: launches {launches}")
        del out
        torch.cuda.empty_cache()
    log(f"phase 15 A/B done at {time.perf_counter() - t0:.1f} s")

    for mode, group in (("CWS", "shift_windows"), ("DEF", "def_windows")):
        zero_counts(kernels)
        out = prof.profile_engine(dev, mode, 2, 1, FRAME, prof.BATCH, pairs=pairs)
        launches = read_counts(kernels)
        share = out["total_ms"] / out["event_ms"]
        log(f"profile {mode} ({smi}), batch {prof.BATCH}, one traced dispatch; "
            f"launches {launches}; grouped device {out['total_ms']:.3f} ms against "
            f"{out['event_ms']:.3f} ms between the CUDA events (share {share:.4f}):"
            + prof.report(out, 15))
        check(abs(share - 1.0) < PROFILE_SHARE,
              f"profile {mode}: grouped {out['total_ms']} ms vs events {out['event_ms']} ms")
        check(out["per_group"].get(group, 0.0) > 0.0 and launches[group] > 0,
              f"profile {mode}: no {group} group ({dict(out['per_group'])})")
        check(out["final_field_shape"] == headline_grid, f"profile {mode}: grid")
        del out
        torch.cuda.empty_cache()
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from torchpiv_tpu_torch.kernels import KERNELS
    from torchpiv_tpu_torch.utils.synthetic import shear_flow

    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        uniform = os.path.join(tmp, "uniform")
        shear = os.path.join(tmp, "shear")
        rough = os.path.join(tmp, "rough")
        linked = os.path.join(tmp, "linked")
        t0 = time.perf_counter()
        write_pairs(uniform, N_PAIRS, DISPLACEMENT, seed=100)
        write_pairs(shear, N_SHEAR_PAIRS, shear_flow(*SHEAR), seed=200)
        write_rough_pairs(uniform, rough, seed=300)
        link_pairs(uniform, linked, N_LINKED)
        log(f"wrote {N_PAIRS} + {N_SHEAR_PAIRS} + {N_PAIRS} pairs of {FRAME} in "
            f"{time.perf_counter() - t0:.1f} s, and {N_LINKED} hard links to the first")
        rows = phase_kernels(uniform)
        log(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")
        cws_launches, pairs_per_s, cws_fields, cws_spans = phase_main_path(uniform, KERNELS)
        def_launches, def_pairs_per_s = phase_def_path(shear, KERNELS)
        bicubic_launches = phase_bicubic_paths(shear, KERNELS)
        fused_runs = phase_fused_paths(uniform, shear, KERNELS)
        variant_runs = phase_variant_paths(uniform, KERNELS, cws_fields,
                                           fused_runs["split"][2])
        robust_launches, robust_pairs_per_s = phase_robust_paths(rough, KERNELS)
        log(f"paths done at {time.perf_counter() - t_start:.1f} s")
        phase_serial_against_pipelined(linked)
        phase_decoders(linked)
        bg_fields = phase_background_preprocess(rough, uniform, tmp, KERNELS)
        log(f"pipeline phases done at {time.perf_counter() - t_start:.1f} s")
        cws = phase_profile(uniform, "CWS")
        log(f"CWS engine: {cws['device_ms']:.3f} ms of device time a batch of {BATCH}; "
            f"{EARLIER_DEVICE_MS['CWS']} ms before the resampling kernels' redesign")
        log(f"CWS path: engine busy share {cws['ms_pair'] * pairs_per_s / 1e3:.3f} "
            f"(engine ms/pair x pairs/s; the rest is host work the card waits on), "
            f"{cws_spans['busy_share_spans']:.3f} from the spans (device ms over wall)")
        fused_profiles = {}
        for fused, (_, fused_pairs_per_s, _, spans) in fused_runs.items():
            prof = fused_profiles[fused] = phase_profile(uniform, f"CWS fused={fused}",
                                                         fused=fused)
            check_fused_profile(prof, cws, f"CWS fused={fused}")
            log(f"CWS fused={fused}: engine {prof['ms_batch']:.3f} ms per batch "
                f"(unfused {cws['ms_batch']:.3f}), peak memory "
                f"{prof['peak_bytes'] / 2**20:.1f} MiB (unfused "
                f"{cws['peak_bytes'] / 2**20:.1f}), busy share "
                f"{prof['ms_pair'] * fused_pairs_per_s / 1e3:.3f}, "
                f"{spans['busy_share_spans']:.3f} from the spans")
        def_xla = phase_profile(shear, "DEF peakfit=xla", multipass_mode="DEF")
        xla_ms = def_xla["ms_pair"]
        def_prof = phase_profile(shear, "DEF peakfit=pallas", multipass_mode="DEF",
                                 peakfit="pallas")
        def_ms = def_prof["ms_pair"]
        log(f"DEF engine (peakfit=pallas): {def_prof['device_ms']:.3f} ms of device time "
            f"a batch of {BATCH} (peakfit {kernel_ms(def_prof, 'peakfit'):.3f} ms); "
            f"{EARLIER_DEVICE_MS['DEF peakfit=pallas']} ms before the peak fit's "
            f"redesign")
        log(f"DEF path: engine {def_ms:.3f} ms/pair with peakfit=pallas, "
            f"{xla_ms:.3f} with peakfit=xla; busy share "
            f"{def_ms * def_pairs_per_s / 1e3:.3f}")
        bf16 = phase_profile(uniform, "CWS shift_variant=bf16", shift_variant="bf16")
        log(f"CWS shift_variant=bf16: engine {bf16['ms_batch']:.3f} ms per batch "
            f"(rolls {cws['ms_batch']:.3f}), {bf16['device_ms']:.3f} ms of device time "
            f"(rolls {cws['device_ms']:.3f}; "
            f"{EARLIER_DEVICE_MS['CWS shift_variant=bf16']} ms before the bf16 shift's "
            f"redesign), busy share "
            f"{bf16['ms_pair'] * variant_runs['pairs_per_s'] / 1e3:.3f}")
        robust = phase_profile(rough, "robust", frame_mask=wall_mask(),
                               shift_variant="phases", **ROBUST)
        log(f"robust path: engine {robust['ms_batch']:.3f} ms per batch "
            f"(plain CWS {cws['ms_batch']:.3f}), {robust['device_ms']:.3f} ms of "
            f"it on the device, peak memory "
            f"{robust['peak_bytes'] / 2**20:.1f} MiB, busy share "
            f"{robust['ms_pair'] * robust_pairs_per_s / 1e3:.3f}")
        cubic = phase_profile(shear, "CWS bicubic", cws_interp="bicubic")
        log(f"CWS + bicubic: engine {cubic['ms_batch']:.3f} ms per batch, "
            f"{cubic['device_ms']:.3f} ms of it on the device "
            f"(shift_windows_bicubic {kernel_ms(cubic, 'bicubic'):.3f} ms)")
        filled = phase_profile(rough, "infill=fused", frame_mask=wall_mask(),
                               infill="fused", **ROBUST)
        n_launched = len(filled["kernels"])
        log(f"infill=fused: engine {filled['ms_batch']:.3f} ms per batch, "
            f"{filled['device_ms']:.3f} ms of it on the device in "
            f"{filled['n_device_events']} kernel launches and copies "
            f"({n_launched} kinds)")
        phase_reference(uniform, "CWS")
        phase_reference(rough, "robust", frame_mask=wall_mask(),
                        shift_variant="phases", **ROBUST)
        phase_reference(shear, "DEF", multipass_mode="DEF", peakfit="pallas")
        phase_reference(shear, "DEF bicubic", multipass_mode="DEF", cws_interp="bicubic",
                        peakfit="pallas")
        phase_reference(shear, "CWS bicubic", cws_interp="bicubic")
        phase_reference(uniform, "CWS fused=split", fused="split")
        phase_reference(uniform, "CWS fused=on", fused="on")
        for label, folder, kw in BF16_STORE_PATHS:
            phase_reference({"uniform": uniform, "shear": shear}[folder],
                            f"{label} correlator=matmul dft_precision=default",
                            correlator="matmul", dft_precision="default", **kw)
        log(f"reference phase done at {time.perf_counter() - t_start:.1f} s")
        frames_a = first_batch(uniform)[0].float()
        phase_row_blocks(frames_a)
        del frames_a
        phase_mesh(uniform, shear, rough, cws_fields, bg_fields, KERNELS)
        log(f"mesh phase done at {time.perf_counter() - t_start:.1f} s")
        phase_streaming(uniform, tmp, KERNELS, cws_fields, smi)
        log(f"streaming phase done at {time.perf_counter() - t_start:.1f} s")
        phase_models(uniform, KERNELS, smi)
        log(f"models phase done at {time.perf_counter() - t_start:.1f} s")
        cli_launches = phase_cli(uniform, shear, tmp, KERNELS, cws_fields, smi)
        log(f"command-line phase done at {time.perf_counter() - t_start:.1f} s")
        # phase 7's kernel paths, beside which phase 13 prints the XLA paths
        kernel_profiles = {"CWS": cws, "DEF": def_xla, "CWS bicubic": cubic,
                           "CWS fused=split": fused_profiles["split"]}
        phase_xla_paths(uniform, shear, tmp, KERNELS, kernel_profiles, smi)
        log(f"XLA-path phase done at {time.perf_counter() - t_start:.1f} s")
        phase_scripts(tmp, KERNELS, smi)
        log(f"scripts phase done at {time.perf_counter() - t_start:.1f} s")
        phase_tools(KERNELS, smi)
        log(f"tools phase done at {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches on the path that runs it
    on_path = {"shift_windows": cws_launches, "shift_windows_bicubic": bicubic_launches,
               "def_windows": def_launches, "peakfit": def_launches,
               "correlate_peakfit": fused_runs["split"][0],
               "fused_piv_pass": fused_runs["on"][0],
               "shift_windows_bf16": variant_runs["bf16"],
               "shift_windows_lanephases": variant_runs["lanephases"],
               "shift_windows_mxu": variant_runs["mxu"],
               "shift_windows_phases": robust_launches}
    check([r["name"] for r in rows] != [] and
          sorted(r["name"] for r in rows) == sorted([k.__name__ for k in KERNELS]
                                                    + [ANATOMY_ROW]),
          "the kernels line does not list every kernel of the package and the "
          "anatomy tool's")
    for row in rows:
        if row["name"] != ANATOMY_ROW:  # that row counts the tool's own run
            row["launches"] = on_path[row["name"]][row["name"]]
        check(row["launches"] > 0, f"{row['name']} was not launched on its path")
    for name, n in cli_launches.items():
        check(n > 0, f"{name} was not launched through tpiv-torch")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
