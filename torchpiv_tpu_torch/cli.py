"""``tpiv-torch`` — the port's headless command-line front end (the
counterpart of ``torchpiv_tpu/cli.py``, entry point ``tpiv``).

The reference is driven from a PyQt5 GUI (`torchPIV.runGUI()`); production
analysis boxes are headless, so the primary front end here is a CLI with
the same capabilities: offline folder analysis, online (streaming) mode,
per-pair saving, ensemble statistics, and settings.json round-trip.
``tpiv-torch gui`` launches the Qt GUI when PyQt5 is installed.

    tpiv-torch run <folder> --multipass 2        # or: python -m torchpiv_tpu_torch.cli

Every subcommand of ``tpiv`` is here, with the same names, options,
defaults, outputs and exit codes, on the port's modules.  One change to
the option set: the subcommands that touch the device and run on JAX's
default device in ``tpiv`` (``warmup``, ``qc``, ``dense``, ``multidt``,
``ptv``) take ``--device``, default ``"auto"``, since the port has no
default-device switch.  ``"auto"`` is the CUDA card: without one these
subcommands exit with an error that names ``--device cpu`` and never
carry on on the CPU.  ``warmup`` and ``doctor`` build the CUDA kernels and
the native decoder into the build cache (``utils.compile_cache``,
``TORCHPIV_CACHE_DIR``) where ``tpiv`` fills XLA's compilation cache.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

from .utils.config import PIVParams


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("folder", help="folder of frame images")
    p.add_argument("--file-fmt", default=".bmp", help="image extension filter")
    p.add_argument("--wind-size", type=int, default=64)
    p.add_argument("--overlap", type=int, default=32)
    p.add_argument("--multipass", type=int, default=1)
    p.add_argument("--multipass-mode", choices=["CWS", "DWS", "DEF"], default="CWS")
    p.add_argument("--multipass-scale", type=float, default=2.0)
    p.add_argument("--scale", type=float, default=1.0, help="mm per pixel")
    p.add_argument("--dt", type=float, default=1.0, help="frame interval, us")
    p.add_argument("--device", default="auto")
    p.add_argument(
        "--save",
        choices=["Dont save", "Save statistics", "Save all text", "Save all binary"],
        default="Save statistics",
        dest="save_opt",
    )
    p.add_argument("--save-dir", default="./Out")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument(
        "--median-filter", choices=["none", "median", "normmedian"],
        default="none",
        help="extra vector-field outlier test on top of peak-ratio validation",
    )
    p.add_argument(
        "--background", choices=["none", "auto"], default="none",
        help="temporal-minimum background subtraction before analysis",
    )
    p.add_argument(
        "--preprocess", choices=["none", "clahe", "stretch"], default="none",
        help="frame conditioning before analysis (CLAHE / percentile "
             "contrast stretch, for uneven illumination or low contrast)",
    )
    p.add_argument(
        "--window-weight", choices=["none", "gaussian"], default="none",
        help="sub-window anti-leakage taper before correlation",
    )
    p.add_argument(
        "--u-limits", default=None, metavar="MIN,MAX",
        help="global u-displacement bounds in px/frame (vectors outside "
             "are flagged invalid); use --u-limits=-5,5 for negative mins")
    p.add_argument(
        "--v-limits", default=None, metavar="MIN,MAX",
        help="global v-displacement bounds in px/frame")
    p.add_argument(
        "--global-std", type=float, default=None, metavar="K",
        help="global mean±K·sigma outlier test (typical K: 3-6)")
    p.add_argument(
        "--mask", default=None, metavar="IMAGE",
        help="region-of-interest mask image (non-zero pixels = excluded, "
             "e.g. walls/model); masked windows are flagged invalid",
    )
    p.add_argument(
        "--cws-interp", choices=["bilinear", "bicubic"], default="bilinear",
        help="CWS/DEF window resampling kernel (bicubic = quality mode)",
    )
    p.add_argument(
        "--subpixel", choices=["gauss3", "gauss2d"], default="gauss3",
        help="sub-pixel peak estimator (gauss2d = 9-point 2-D fit, lower "
             "bias on tilted elliptical peaks)",
    )
    p.add_argument(
        "--correlation", choices=["scc", "rpc"], default="scc",
        help="correlation estimator: scc = standard cross-correlation "
             "(default), rpc = robust phase correlation — use for images "
             "contaminated by stationary reflections/glare",
    )
    p.add_argument(
        "--rpc-diameter", type=float, default=2.8, metavar="PX",
        help="RPC matched-filter particle image diameter in px",
    )
    p.add_argument(
        "--second-peak-fallback", action="store_true",
        help="vector-recovery ladder: re-validate flagged vectors and try "
             "the second correlation peak against valid neighbours before "
             "infilling (rescued vectors are real measurements)",
    )
    p.add_argument("-v", "--verbose", action="store_true")


def _params_from_args(args, regime: str, folder_mode: str) -> PIVParams:
    return PIVParams(
        wind_size=args.wind_size,
        overlap=args.overlap,
        scale=args.scale,
        dt=args.dt,
        device=args.device,
        multipass=args.multipass,
        file_fmt=args.file_fmt,
        save_opt=args.save_opt,
        save_dir=args.save_dir,
        multipass_scale=args.multipass_scale,
        folder=args.folder,
        regime=regime,
        multipass_mode=args.multipass_mode,
        folder_mode=folder_mode,
    )


def _device(args):
    """``args.device`` as a ``torch.device``.  A CUDA name on a machine
    without a card exits with an error that names ``--device cpu``; the
    command never carries on on the CPU."""
    from .pipeline import DeviceMap

    try:
        return DeviceMap.resolve(args.device)
    except RuntimeError:
        raise SystemExit(f"tpiv-torch: --device {args.device}: no CUDA device "
                         "is available; pass --device cpu to run on the CPU"
                         ) from None
    except ValueError as e:
        raise SystemExit(f"tpiv-torch: {e}") from None


def cmd_run(args) -> int:
    from .pipeline import PIVRunner

    _device(args)
    params = _params_from_args(args, "offline", args.folder_mode)
    params.to_json()  # snapshot settings like the reference GUI's Start

    last = {"pct": -1}

    def on_progress(pct):
        if pct != last["pct"]:
            last["pct"] = pct
            print(f"\rprogress: {pct:3d}%", end="", file=sys.stderr, flush=True)

    engine_options = _engine_options(args)
    shard = None
    if getattr(args, "shard", None):
        from .parallel.distributed import parse_shard

        shard = parse_shard(args.shard)
        if not args.checkpoint:
            raise SystemExit("tpiv-torch: --shard requires --checkpoint PATH "
                             "(the shard's statistics state to merge later)")
    runner = PIVRunner(
        params,
        on_progress=on_progress,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        shard=shard,
        batch_size=args.batch_size,
        validate=not args.no_validate,
        background=args.background,
        preprocess=args.preprocess,
        smooth=_parse_smooth(args.smooth),
        engine_options=engine_options or None,
    )
    table = runner.run()
    print("", file=sys.stderr)
    if table is None:
        print("no pairs processed", file=sys.stderr)
        return 1
    print(f"processed fields; statistics columns: {list(table.keys())}",
          file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """Long-lived HTTP analysis service (serve.py): the engine is built
    once and stays hot; acquisition machines POST frame pairs and get
    fields back.  Endpoints: /healthz /config /metrics, POST /piv (npz
    a/b), POST /piv_files (server-readable paths)."""
    import ast

    from .serve import PIVService, run_server

    engine_options = {}
    for kv in args.engine_option or []:
        if "=" not in kv:
            raise SystemExit(f"tpiv-torch: --engine-option expects KEY=VALUE, "
                             f"got {kv!r}")
        k, v = kv.split("=", 1)
        try:
            engine_options[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            engine_options[k] = v  # plain string (e.g. median_filter=median)
    _device(args)
    service = PIVService(
        device=args.device,
        wind_size=args.wind_size,
        overlap=args.overlap,
        multipass=args.multipass,
        multipass_mode=args.multipass_mode,
        multipass_scale=args.multipass_scale,
        dt=args.dt,
        scale=args.scale,
        validate=not args.no_validate,
        engine_options=engine_options or None,
    )
    if args.warmup:
        try:
            h, w = (int(t) for t in args.warmup.lower().split("x"))
        except ValueError:
            raise SystemExit(f"tpiv-torch: bad --warmup {args.warmup!r}: "
                             "expected HxW")
        print(f"warming engine for {h}x{w} (single + burst graphs)...",
              file=sys.stderr)
        service.warmup((h, w))
        service.pairs_served = 0  # the warmup pair is not traffic
    run_server(service, args.host, args.port)
    return 0


def cmd_merge_stats(args) -> int:
    """Merge shard statistics states (`tpiv-torch run --shard I/N --checkpoint
    s<I>.npz`) into the single 13-column table a sequential run over all
    pairs would produce (exact Welford-state merge, parallel.distributed)."""
    from .parallel.distributed import merge_checkpoints
    from .utils.persistence import save_table

    acc, total, x, y = merge_checkpoints(args.states,
                                         allow_partial=args.allow_partial)
    table = acc.finalize(x, y)
    save_table(f"{args.name}_statistics.txt", args.save_dir, dict(table))
    print(f"merged {len(args.states)} shard states ({total} pairs, "
          f"{acc.n} fields) -> {args.save_dir}/{args.name}_statistics.txt",
          file=sys.stderr)
    return 0


def _engine_options(args) -> dict:
    """Collect the non-default engine knobs shared by run/online/video
    into an ``engine_options`` dict (empty entries omitted so the
    ``PIVConfig`` defaults stay in charge)."""
    engine_options = {}
    if args.median_filter != "none":
        engine_options["median_filter"] = args.median_filter
    if args.window_weight != "none":
        engine_options["window_weight"] = args.window_weight
    if args.cws_interp != "bilinear":
        engine_options["cws_interp"] = args.cws_interp
    if args.subpixel != "gauss3":
        engine_options["subpixel"] = args.subpixel
    if getattr(args, "correlation", "scc") != "scc":
        engine_options["correlation"] = args.correlation
        if args.rpc_diameter != 2.8:
            engine_options["rpc_diameter"] = args.rpc_diameter
    elif getattr(args, "rpc_diameter", 2.8) != 2.8:
        # a typed knob that does nothing is a silent misconfiguration
        raise SystemExit("tpiv-torch: --rpc-diameter only applies to the RPC "
                         "estimator; add --correlation rpc")
    if args.mask:
        engine_options["frame_mask"] = args.mask
    for key, spec in (("u_limits", args.u_limits),
                      ("v_limits", args.v_limits)):
        if spec:
            try:
                lo, hi = (float(t) for t in spec.split(","))
            except ValueError:
                raise SystemExit(
                    f"tpiv-torch: --{key.replace('_', '-')} expects MIN,MAX, "
                    f"got {spec!r}")
            engine_options[key] = (lo, hi)
    if args.global_std is not None:
        engine_options["global_std"] = args.global_std
    if getattr(args, "second_peak_fallback", False):
        engine_options["second_peak_fallback"] = True
    return engine_options


def _parse_smooth(value):
    """--smooth [S]: absent -> off, bare flag -> GCV auto, else a positive
    float smoothing parameter (validated here so a bad value is a clean
    CLI error, not a traceback from the smoother)."""
    if value is None:
        return False
    if value == "auto":
        return True
    try:
        s = float(value)
    except ValueError:
        raise SystemExit(f"tpiv-torch: --smooth expects a number, got {value!r}")
    if s <= 0:
        raise SystemExit("tpiv-torch: --smooth must be > 0 (omit the value for "
                         "automatic GCV selection)")
    return s


def cmd_online(args) -> int:
    from .pipeline import OnlinePIV

    engine_options = _engine_options(args)
    _device(args)
    piv = OnlinePIV(
        folder=args.folder,
        device=args.device,
        file_fmt=args.file_fmt,
        wind_size=args.wind_size,
        overlap=args.overlap,
        multipass=args.multipass,
        multipass_mode=args.multipass_mode,
        dt=args.dt,
        scale=args.scale,
        multipass_scale=args.multipass_scale,
        validate=not args.no_validate,
        idle_timeout=args.idle_timeout,
        preprocess=args.preprocess,
        frame_shape=(tuple(int(d) for d in args.frame_shape.lower()
                           .split("x"))
                     if args.frame_shape else None),
        engine_options=engine_options or None,
    )
    import numpy as np

    for i, (x, y, u, v) in enumerate(piv()):
        print(
            f"pair {i}: |V| median "
            f"{float(np.median(np.hypot(u, v))):.3f} m/s",
            file=sys.stderr,
        )
    return 0


def cmd_video(args) -> int:
    """PIV over a video file (the reference's "PIV Video File" menu intent,
    mainWindow.py:79-86 — nonfunctional there)."""
    import numpy as np

    from .pipeline import VideoPIV
    from .stats import EnsembleAccumulator
    from .utils.persistence import save_table

    _device(args)
    piv = VideoPIV(
        args.video,
        device=args.device,
        wind_size=args.wind_size,
        overlap=args.overlap,
        multipass=args.multipass,
        multipass_mode=args.multipass_mode,
        dt=args.dt,
        scale=args.scale,
        multipass_scale=args.multipass_scale,
        folder_mode=args.pairing,
        batch_size=args.batch_size,
        validate=not args.no_validate,
        max_pairs=args.max_pairs,
    )
    total = len(piv)
    acc = EnsembleAccumulator()
    x = y = None
    for i, (x, y, u, v) in enumerate(piv()):
        acc.add(u, v)
        print(f"pair {i + 1}/{total}: |V| median "
              f"{float(np.median(np.hypot(u, v))):.3f} m/s", file=sys.stderr)
    if acc.n == 0:
        print("no pairs decoded", file=sys.stderr)
        return 1
    if args.save_opt != "Dont save":
        import os

        name = os.path.splitext(os.path.basename(args.video))[0]
        save_table(f"{name}_statistics.txt", args.save_dir,
                   dict(acc.finalize(x, y)))
    return 0


def cmd_bench(args) -> int:
    """The ``bench`` protocol of the root ``bench.py`` on the card, in this
    process (``torchpiv_tpu_torch.bench``)."""
    from .bench import main as bench_main

    return bench_main()


def cmd_doctor(args) -> int:
    """Environment self-check before a production run: devices, build
    cache, native decoder, host->device bandwidth, dispatch latency, and
    an engine smoke test against known synthetic flow."""
    from .utils.doctor import format_report, run_doctor

    results = run_doctor(device=args.device,
                         engine_check=not args.no_engine,
                         bandwidth_mb=args.bandwidth_mb,
                         cache_roundtrip=args.cache)
    print(format_report(results))
    return 0 if all(r["ok"] for r in results) else 1


def cmd_warmup(args) -> int:
    """Build every CUDA kernel and the native decoder into the build cache
    (``utils.compile_cache``) and run the engine once for the frame shape,
    so the FIRST real run of a fresh process starts without building.  Run
    it once after installing (e.g. in a deploy step): ``tpiv-torch warmup
    2048x2048 --wind-size 64 --overlap 32 --multipass 2``."""
    import time

    import torch

    from .config import PIVConfig
    from .kernels import _build
    from .models.multipass import MultipassPIV
    from .native import loader
    from .pipeline import packed_forward
    from .utils.compile_cache import enable_compile_cache

    try:
        h, w = (int(t) for t in args.frame.lower().split("x"))
    except ValueError:
        print(f"bad --frame {args.frame!r}: expected HxW, e.g. 2048x2048",
              file=sys.stderr)
        return 1
    device = _device(args)
    t0 = time.perf_counter()
    if device.type == "cuda":  # the CPU runs the kernels' plain versions
        try:
            _build.build()
        except RuntimeError as e:  # no nvcc, or a source it refuses
            print(f"kernel build failed: {e}", file=sys.stderr)
            return 1
        kernels = f"{len(_build.sources())} CUDA kernels"
    else:
        kernels = "no CUDA kernels (device cpu runs their plain versions)"
    if not loader.available():
        print("native decoder build failed (g++): the pipeline would fall "
              "back to the Python decoders", file=sys.stderr)
        return 1
    build_s = time.perf_counter() - t0
    cfg = PIVConfig(
        frame_shape=(h, w), wind_size=args.wind_size, overlap=args.overlap,
        multipass=args.multipass, multipass_mode=args.multipass_mode,
        multipass_scale=args.multipass_scale,
    )
    engine = MultipassPIV(cfg, device=device)
    batch = max(1, args.batch_size)
    # the batch sizes OfflinePIV runs: its small first batch and full ones
    sizes = sorted({min(4, batch), batch})
    t0 = time.perf_counter()
    for b in sizes:
        fa = torch.zeros((b, h, w), dtype=torch.uint8, device=device)
        packed_forward(engine, fa, fa).cpu()
    print(f"{kernels} and the native decoder built + cached in "
          f"{enable_compile_cache()} ({build_s:.1f} s); engine run in "
          f"{time.perf_counter() - t0:.1f} s (frame {h}x{w}, wind "
          f"{args.wind_size}, batch sizes {sizes}, {args.multipass}-pass "
          f"{args.multipass_mode}, {device}); subsequent processes load the "
          f"libraries from the cache")
    return 0


def cmd_qc(args) -> int:
    """Measurement-quality report for a folder: per-pair SNR map summary +
    peak-locking degree over the recovered displacement field
    (stats/quality.py; diagnostics the reference lacks)."""
    import numpy as np
    import torch

    from .io.dataset import PIVDataset
    from .stats.quality import (peak_locking_degree, peak_width_map,
                                snr_map, uncertainty_map)

    ds = PIVDataset(args.folder, args.file_fmt, folder_mode=args.folder_mode)
    if len(ds) == 0:
        print("no pairs found", file=sys.stderr)
        return 1
    device = _device(args)
    n = min(len(ds), args.pairs)
    fa = None
    for i in range(n):
        fa, fb = ds[i]
        if fa is None:
            print(f"pair {i}: unreadable, skipped", file=sys.stderr)
            continue
        s = snr_map(fa, fb, wind_size=args.wind_size, overlap=args.overlap,
                    device=device)
        lo = float(np.quantile(s, 0.05))
        print(f"pair {i}: SNR median {np.median(s):.2f}  p5 {lo:.2f}  "
              f"min {s.min():.2f}  <{args.val_ratio}: "
              f"{(s < args.val_ratio).mean():.1%}")
        sx, sy = peak_width_map(fa, fb, wind_size=args.wind_size,
                                overlap=args.overlap, device=device)
        d_tau = 2.0 * np.sqrt(2.0) * np.nanmedian((sx + sy) / 2.0)
        note = ("OK" if 1.5 <= d_tau <= 5.0 else
                ("peak-locking risk (particles too small)" if d_tau < 1.5
                 else "defocus / oversized particle images"))
        print(f"pair {i}: particle-image diameter d_tau ~ {d_tau:.1f} px "
              f"({note})")
        su, sv = uncertainty_map(fa, fb, wind_size=args.wind_size,
                                 overlap=args.overlap, device=device)
        sig = np.nanmedian(np.hypot(su, sv))
        print(f"pair {i}: sub-pixel uncertainty median "
              f"{sig:.3f} px  p95 "
              f"{np.nanquantile(np.hypot(su, sv), 0.95):.3f} px")
    # peak locking from a quick single-pass field on the first pair
    from .config import PIVConfig
    from .models.multipass import MultipassPIV

    fa, fb = ds[0]
    if fa is None:
        return 1
    cfg = PIVConfig(frame_shape=fa.shape, wind_size=args.wind_size,
                    overlap=args.overlap, multipass=1)
    u, v, inval = MultipassPIV(cfg, device=device)(
        torch.from_numpy(fa).to(device), torch.from_numpy(fb).to(device))
    inval = inval.cpu().numpy()
    cu = peak_locking_degree(u.cpu().numpy(), mask=inval)
    cv = peak_locking_degree(v.cpu().numpy(), mask=inval)
    verdict = ("OK" if max(cu, cv) < 0.3
               else "BIASED — particle images likely too small for the "
                    "3-point fit")
    print(f"peak-locking degree: u {cu:.2f}  v {cv:.2f}  ({verdict})")

    # seeding density from the particle detector (ops/particles.py):
    # the classic guideline is >= 5-10 particles per interrogation window
    from .ops.particles import detect_particles

    cap = max(4096, fa.size // 256)
    _, _, _, pvalid = detect_particles(torch.from_numpy(fa).to(device), cap, 3)
    n_part = int(pvalid.sum())
    per_win = n_part * args.wind_size**2 / fa.size
    if n_part >= cap:
        print(f"seeding: >= {n_part} particles (detector capacity hit)")
    else:
        rec = ""
        if per_win < 5:
            # smallest power-of-two window with >= 5 expected particles
            need = int(np.ceil(np.sqrt(5 * fa.size / max(n_part, 1))))
            w = 8
            while w < need:
                w *= 2
            rec = (f" — sparse for {args.wind_size} px windows; consider "
                   f"wind_size >= {w}, ensemble correlation, or PTV")
        elif per_win > 40:
            rec = (f" — dense; wind_size {max(args.wind_size // 2, 16)} "
                   f"would still hold ~{per_win / 4:.0f} particles")
        print(f"seeding: ~{n_part} particles, ~{per_win:.1f} per "
              f"{args.wind_size} px window{rec}")
    return 0


def cmd_pod(args) -> int:
    """Snapshot POD over saved per-pair binary fields (stats/pod.py;
    turbulence post-analysis the reference lacks).  Input: a folder of
    ``*.npy`` files as written by ``--save 'Save all binary'`` (each
    ``[4, R, C]`` = x, y, u, v)."""
    import glob
    import os

    import numpy as np

    from .stats.pod import compute_pod
    from .utils.persistence import saved_series_key, save_binary, save_table

    files = sorted(glob.glob(os.path.join(args.folder, "*.npy")),
                   key=saved_series_key)
    stacks_u, stacks_v = [], []
    x = y = None
    for f in files:
        arr = np.load(f)
        if arr.ndim != 3 or arr.shape[0] != 4:
            print(f"skipping {f}: not a [4, R, C] pair file",
                  file=sys.stderr)
            continue
        x, y = arr[0], arr[1]
        stacks_u.append(arr[2])
        stacks_v.append(arr[3])
    if len(stacks_u) < 2:
        print("need >= 2 saved pair files for POD", file=sys.stderr)
        return 1
    pod = compute_pod(np.stack(stacks_u), np.stack(stacks_v),
                      n_modes=args.modes)
    print(f"{len(stacks_u)} snapshots, {pod.modes_u.shape[1]}x"
          f"{pod.modes_u.shape[2]} grid")
    cum = 0.0
    for m, frac in enumerate(pod.energy_fraction):
        cum += float(frac)
        print(f"mode {m}: energy {frac:.1%}  (cumulative {cum:.1%})")
    if args.out:
        for m in range(pod.modes_u.shape[0]):
            save_binary(f"pod_mode{m}.npy", args.out,
                        {"x": x, "y": y,
                         "u": pod.modes_u[m], "v": pod.modes_v[m]})
        save_table("pod_coeffs.txt", args.out,
                   {f"a{m}[.]": pod.coeffs[:, m]
                    for m in range(pod.coeffs.shape[1])})
        print(f"modes + temporal coefficients written to {args.out}")
    return 0


def cmd_spod(args) -> int:
    """Spectral POD over saved per-pair binary fields (stats/spod.py):
    per-frequency coherent structures of a TIME-RESOLVED sequence sampled
    at --fs.  Input format as `tpiv-torch pod` (``[4, R, C]`` .npy files)."""
    import glob
    import os

    import numpy as np

    from .stats.spod import compute_spod
    from .utils.persistence import saved_series_key, save_binary, save_table

    files = sorted(glob.glob(os.path.join(args.folder, "*.npy")),
                   key=saved_series_key)
    stacks_u, stacks_v = [], []
    x = y = None
    for f in files:
        arr = np.load(f)
        if arr.ndim != 3 or arr.shape[0] != 4:
            print(f"skipping {f}: not a [4, R, C] pair file",
                  file=sys.stderr)
            continue
        x, y = arr[0], arr[1]
        stacks_u.append(arr[2])
        stacks_v.append(arr[3])
    if len(stacks_u) < 4:
        print("need >= 4 saved pair files for SPOD", file=sys.stderr)
        return 1
    if args.modes < 1 or args.peaks < 1:
        print("--modes and --peaks must be >= 1", file=sys.stderr)
        return 1
    res = compute_spod(np.stack(stacks_u), np.stack(stacks_v), fs=args.fs,
                       n_fft=args.n_fft, overlap=args.overlap,
                       n_modes=args.modes)
    spec = res.spectrum()
    print(f"{len(stacks_u)} snapshots, {res.n_blocks} Welch blocks, "
          f"df = {res.freqs[1] - res.freqs[0]:.4g} Hz")
    order = np.argsort(spec)[::-1][: args.peaks]
    for j in sorted(order):
        lead = res.energies[j, 0] / spec[j] if spec[j] > 0 else 0.0
        print(f"f = {res.freqs[j]:9.4g} Hz: energy {spec[j]:.4g} "
              f"({spec[j] / spec.sum():.1%} of total), "
              f"mode-1 share {lead:.1%}")
    if args.out:
        save_table("spod_spectrum.txt", args.out,
                   {"f[Hz]": res.freqs,
                    **{f"lambda{m}[.]": res.energies[:, m]
                       for m in range(res.energies.shape[1])}})
        for j in order:
            mode_u, mode_v = res.modes_u[j, 0], res.modes_v[j, 0]
            save_binary(f"spod_f{res.freqs[j]:.4g}Hz_mode0.npy", args.out,
                        {"x": x, "y": y,
                         "u_re": mode_u.real, "u_im": mode_u.imag,
                         "v_re": mode_v.real, "v_im": mode_v.imag})
        print(f"spectrum + peak modes written to {args.out}")
    return 0


def cmd_export(args) -> int:
    """Convert a saved PIV result (CSV table from ``save_table`` or
    ``[4, R, C]`` .npy from ``save_binary``) to legacy-ASCII VTK for
    ParaView/VisIt, MATLAB v5 ``.mat`` (PIVlab interop) or HDF5 (beyond
    the reference's npy/CSV formats).  Derived maps (vorticity, swirling
    strength) ride along as point scalars."""
    import os

    import numpy as np

    from .stats.derived import derived_fields
    from .utils.persistence import load_table, save_hdf5, save_mat, save_vtk

    if args.result.endswith(".npy"):
        arr = np.load(args.result)
        if arr.ndim != 3 or arr.shape[0] < 4:
            print(f"{args.result}: expected a [4, R, C] pair file",
                  file=sys.stderr)
            return 1
        x, y, u, v = arr[0], arr[1], arr[2], arr[3]
    else:
        table = load_table(args.result)
        cols = list(table)
        if len(cols) < 4:
            print(f"{args.result}: need at least x, y, u, v columns",
                  file=sys.stderr)
            return 1
        x, y, u, v = (table[c] for c in cols[:4])
    dx = float(abs(x[0, 1] - x[0, 0])) or 1.0
    dy = float(abs(y[1, 0] - y[0, 0])) or 1.0
    scalars = derived_fields(u, v, dx=dx, dy=dy) if args.derived else None
    fmt = getattr(args, "format", "vtk")
    writer = {"vtk": save_vtk, "mat": save_mat, "h5": save_hdf5}[fmt]
    base = os.path.splitext(os.path.basename(args.result))[0] + "." + fmt
    out = writer(base, args.out, x, y, u, v, scalars=scalars)
    print(f"wrote {out}")
    return 0


def cmd_ensemble(args) -> int:
    """Correlation-averaged (ensemble) PIV over a whole folder (Meinhart
    et al. 2000): sum the correlation planes of EVERY pair on device, then
    peak-fit the average once — the micro-PIV standard for sparse seeding
    where single pairs carry too few particles for reliable peaks.  Beyond
    the reference (no ensemble mode there); ``models.EnsemblePIV`` is the
    Python API."""
    import numpy as np
    import torch

    from .config import PIVConfig
    from .io.dataset import PIVDataset, compute_background
    from .io.preprocess import PreprocessedPairs, resolve_preprocess
    from .models.ensemble_corr import EnsemblePIV
    from .pipeline import finalize_fields
    from .utils.persistence import save_table

    ds = PIVDataset(args.folder, args.file_fmt, args.folder_mode)
    pp = resolve_preprocess(args.preprocess)
    if pp is not None:
        ds = PreprocessedPairs(ds, pp)
    if len(ds) == 0:
        print(f"no {args.file_fmt} pairs in {args.folder}", file=sys.stderr)
        return 1
    device = _device(args)
    bg = compute_background(ds) if args.background == "auto" else None

    first = None
    for i in range(len(ds)):
        a, _ = ds[i]
        if a is not None:
            first = a
            break
    if first is None:
        print("no readable pairs", file=sys.stderr)
        return 1

    cfg_kwargs = dict(
        frame_shape=tuple(first.shape),
        wind_size=args.wind_size,
        overlap=args.overlap,
        multipass=1,
        validate=not args.no_validate,
        correlation=args.correlation,
    )
    if args.correlation == "rpc":
        cfg_kwargs["rpc_diameter"] = args.rpc_diameter
    if args.window_weight != "none":
        cfg_kwargs["window_weight"] = args.window_weight
    ens = EnsemblePIV(PIVConfig(**cfg_kwargs), device=device)
    bgt = torch.from_numpy(bg).to(device) if bg is not None else None

    def accum(csum, fa, fb):
        if bgt is not None:  # saturating uint8 background subtract
            fa = torch.where(fa > bgt, fa - bgt, 0)
            fb = torch.where(fb > bgt, fb - bgt, 0)
        return csum + ens.corr_batch(fa, fb)

    n_windows = ens.engine.field_shapes[0][0] * ens.engine.field_shapes[0][1]
    w = ens.engine.schedule[0][0]
    batch_a, batch_b = [], []
    count = skipped = 0
    B = max(1, args.batch_size)
    # the running sum stays on the device; one finalize at the end
    csum = torch.zeros((n_windows, w, w), dtype=torch.float32, device=device)

    def flush():
        nonlocal csum, count
        if not batch_a:
            return
        csum = accum(csum, torch.from_numpy(np.stack(batch_a)).to(device),
                     torch.from_numpy(np.stack(batch_b)).to(device))
        count += len(batch_a)
        batch_a.clear()
        batch_b.clear()

    for i in range(len(ds)):
        a, b = ds[i]
        if a is None or b is None or a.shape != first.shape:
            skipped += 1
            continue
        batch_a.append(a)
        batch_b.append(b)
        if len(batch_a) == B:
            flush()
    flush()
    if count == 0:
        print("no readable pairs", file=sys.stderr)
        return 1
    u, v, inval = ens.finalize(csum / count)

    u, v = u.cpu().numpy(), v.cpu().numpy()
    inval = inval.cpu().numpy() if inval is not None else None
    x, y = ens.final_coordinates
    x, y = np.asarray(x), np.asarray(y)
    n_inval = int(inval.sum()) if inval is not None else 0
    fields = finalize_fields(u, v, inval, x, y, args.scale, args.dt)
    if fields is None:
        print("ensemble field >50% invalid — not enough correlation "
              "signal; check seeding/window size", file=sys.stderr)
        return 1
    x, y, u, v = fields
    out = save_table("ensemble_field.txt", args.out,
                     {"x[mm]": x, "y[mm]": y, "Vx[m/s]": u, "Vy[m/s]": v})
    msg = f"averaged {count} pairs"
    if skipped:
        msg += f" ({skipped} skipped)"
    msg += (f"; {n_inval}/{u.size} vectors infilled; wrote {out}")
    print(msg, file=sys.stderr)
    return 0


def cmd_temporal(args) -> int:
    """Temporal analysis of a time-resolved run (stats/temporal.py; the
    reference has no time-domain tooling at all).  Input: a folder of
    ``[4, R, C]`` per-pair binaries; reports run-convergence numbers and,
    for each ``--point r,c`` probe, the dominant frequency and integral
    time scale; ``--out`` writes probe PSD + running-mean tables."""
    import numpy as np

    from .stats.temporal import (convergence_report, integral_time_scale,
                                 load_pair_stack, probe_series,
                                 running_mean, welch_psd)
    from .utils.persistence import save_table

    try:
        stack = load_pair_stack(args.folder)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    u, v = stack["u"], stack["v"]
    rep = convergence_report(u, v, fs=args.fs)
    print(f"{int(rep['snapshots'])} snapshots @ {args.fs:g} Hz")
    print(f"integral time scale: {rep['integral_time_scale_s']:.4g} s  "
          f"-> {rep['effective_samples']:.0f} independent samples")
    print(f"mean speed {rep['mean_speed']:.4g}  "
          f"relative SEM {rep['relative_sem']:.2%}")
    points = []
    for spec in args.point or []:
        r, sep, c = spec.partition(",")
        try:
            if not sep:
                raise ValueError
            pr, pc = int(r), int(c)
        except ValueError:
            print(f"--point expects ROW,COL grid indices, got {spec!r}",
                  file=sys.stderr)
            return 1
        if not (0 <= pr < u.shape[1] and 0 <= pc < u.shape[2]):
            print(f"--point {spec} is outside the {u.shape[1]}x{u.shape[2]} "
                  f"vector grid", file=sys.stderr)
            return 1
        points.append((pr, pc))
    if not points:
        points = [(u.shape[1] // 2, u.shape[2] // 2)]
    series = probe_series(u, v, points)
    tables = {}
    for name, s in series.items():
        freqs, psd = welch_psd(s, fs=args.fs, nperseg=args.nperseg)
        psd = np.atleast_2d(psd.T).T
        for p, (r, c) in enumerate(points):
            fpk = freqs[1:][int(np.nanargmax(psd[1:, p]))] if len(freqs) > 1 \
                else 0.0
            tis = integral_time_scale(s[:, p], fs=args.fs)
            print(f"probe ({r},{c}) {name}: peak {fpk:.4g} Hz, "
                  f"T_int {tis:.4g} s")
            tables[f"psd_{name}_{r}_{c}[1]"] = psd[:, p]
        tables.setdefault("f[Hz]", freqs)
    if args.phase_bins:
        from .stats.temporal import phase_average, phase_from_probe
        from .utils.persistence import save_binary

        r0, c0 = points[0]
        phase = phase_from_probe(u[:, r0, c0])
        centers, ua, va, counts = phase_average(u, v, phase,
                                                n_bins=args.phase_bins)
        print(f"phase average over probe ({r0},{c0}): bin counts "
              f"{counts.tolist()}")
        if args.out:
            for b in range(args.phase_bins):
                if counts[b]:
                    save_binary(f"phase_bin{b}.npy", args.out,
                                {"x": stack["x"], "y": stack["y"],
                                 "u": ua[b], "v": va[b]})
            print(f"{int((counts > 0).sum())} phase-bin fields written "
                  f"to {args.out}")
    if args.out:
        out = save_table("temporal_psd.txt", args.out, tables)
        rm = running_mean(np.hypot(series["u"], series["v"]))
        cols = {"n[1]": np.arange(1, rm.shape[0] + 1, dtype=np.float64)}
        for p, (r, c) in enumerate(points):
            cols[f"runmean_speed_{r}_{c}[1]"] = rm[:, p]
        out2 = save_table("temporal_convergence.txt", args.out, cols)
        print(f"wrote {out}\nwrote {out2}")
    return 0


def cmd_dense(args) -> int:
    """Dense Lucas-Kanade (FOLKI-style) analysis of a folder
    (models/folki.py): per-pixel optical-flow solve window-averaged onto
    the PIV grid; output tables follow the pipeline contract (infill,
    y flip, mm / m/s)."""
    import numpy as np

    from .io.dataset import PIVDataset
    from .models.folki import FolkiPIV
    from .pipeline import finalize_fields
    from .utils.persistence import save_table

    ds = PIVDataset(args.folder, args.file_fmt, folder_mode=args.folder_mode)
    if len(ds) == 0:
        print("no pairs found", file=sys.stderr)
        return 1
    device = _device(args)
    fp = None
    n_done = 0
    n = len(ds) if args.pairs is None else min(len(ds), args.pairs)
    for i in range(n):
        fa, fb = ds[i]
        if fa is None:
            print(f"pair {i}: unreadable, skipped", file=sys.stderr)
            continue
        if fp is None:
            cfg = None
            if args.hybrid:
                from .config import PIVConfig

                # the engine's FINAL pass must land on the dense grid:
                # 2-pass halving doubles both knobs
                cfg = PIVConfig(frame_shape=fa.shape,
                                wind_size=args.wind_size * 2,
                                overlap=args.overlap * 2,
                                multipass=2)
            fp = FolkiPIV(fa.shape, wind_size=args.wind_size,
                          overlap=args.overlap, iters=args.iters,
                          levels=args.levels, piv_config=cfg,
                          device=device)
        try:
            u, v, bad = fp(fa, fb)
        except ValueError as e:
            print(f"dense solve failed: {e} (hint: --levels or frame "
                  f"padding)", file=sys.stderr)
            return 1
        out = finalize_fields(u, v, bad, *fp.coordinates,
                              scale=args.scale, dt=args.dt)
        if out is None:
            print(f"pair {i}: >50% untrusted windows, skipped",
                  file=sys.stderr)
            continue
        x, y, up, vp = out
        print(f"pair {i}: mean |V| {np.hypot(up, vp).mean():.4g} m/s, "
              f"untrusted {bad.mean():.1%}")
        if args.out:
            save_table(f"dense_{i:04d}.txt", args.out, {
                "x[mm]": x, "y[mm]": y, "Vx[m/s]": up, "Vy[m/s]": vp})
        n_done += 1
    if args.out and n_done:
        print(f"{n_done} dense-field tables written to {args.out}")
    return 0 if n_done else 1


def cmd_report(args) -> int:
    """One-command campaign report over saved per-pair binaries: mean
    field + vorticity figures, convergence numbers, turbulence scales,
    energy spectrum, POD energies, optional mean pressure — a markdown
    file plus PNGs, ready to archive with the data."""
    import os

    import numpy as np

    from .stats.pod import compute_pod
    from .stats.derived import derived_fields
    from .stats.pressure import mean_pressure_rans
    from .stats.spectra import energy_spectrum
    from .stats.temporal import convergence_report, load_pair_stack
    from .stats.turbulence import turbulence_report

    try:
        stack = load_pair_stack(args.folder)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    x, y, u, v = stack["x"], stack["y"], stack["u"], stack["v"]
    out = args.out or os.path.join(args.folder, "report")
    os.makedirs(out, exist_ok=True)
    dx = abs(float(x[0, 1] - x[0, 0])) / 1000.0
    dy = abs(float(y[1, 0] - y[0, 0])) / 1000.0

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.errstate(invalid="ignore"):
        mu = np.nan_to_num(np.nanmean(u, axis=0))
        mv = np.nan_to_num(np.nanmean(v, axis=0))

    figs = []

    def save_fig(fig, name):
        path = os.path.join(out, name)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        figs.append(name)

    fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 4.5))
    im = a1.pcolormesh(x, y, np.hypot(mu, mv), cmap="viridis",
                       shading="auto")
    fig.colorbar(im, ax=a1, label="|V| [m/s]")
    a1.set_title(f"mean speed ({u.shape[0]} snapshots)")
    w = derived_fields(mu, mv, dx=dx, dy=dy)["vorticity"]
    lim = np.abs(w).max() or 1.0
    im = a2.pcolormesh(x, y, w, cmap="RdBu_r", vmin=-lim, vmax=lim,
                       shading="auto")
    fig.colorbar(im, ax=a2, label="ω [1/s]")
    a2.set_title("mean vorticity")
    for a in (a1, a2):
        a.set_aspect("equal")
    save_fig(fig, "mean_field.png")

    lines = [f"# PIV campaign report — {os.path.abspath(args.folder)}",
             "",
             f"{u.shape[0]} snapshots, {u.shape[1]}x{u.shape[2]} vectors, "
             f"grid step {dx*1000:g} x {dy*1000:g} mm",
             "", "![mean field](mean_field.png)", ""]

    rep = convergence_report(u, v, fs=args.fs)
    lines += ["## Convergence", "",
              f"* integral time scale {rep['integral_time_scale_s']:.4g} s "
              f"→ {rep['effective_samples']:.0f} independent samples",
              f"* mean speed {rep['mean_speed']:.4g} m/s, relative SEM "
              f"{rep['relative_sem']:.2%}", ""]

    tr = turbulence_report(u, v, nu=args.nu, dx=dx, dy=dy)
    lines += ["## Turbulence scales", "",
              "| quantity | value |", "|---|---|"]
    units = {"tke": "m^2/s^2", "u_rms": "m/s", "dissipation": "m^2/s^3",
             "eta": "m", "tau_eta": "s", "u_eta": "m/s",
             "taylor_microscale": "m", "re_lambda": "-",
             "integral_length": "m", "resolution_dx_over_eta": "-"}
    for k, val in tr.items():
        lines.append(f"| {k} | {val:.6g} {units.get(k, '')} |")
    if tr["resolution_dx_over_eta"] > 3:
        lines.append("")
        lines.append("*dx/eta > 3: dissipative scales under-resolved — "
                     "the direct dissipation estimate is a lower bound.*")
    lines.append("")

    try:
        kx, Eu = energy_spectrum(u[0] - mu, v[0] - mv, dx=dx)
        fig, a = plt.subplots(figsize=(6, 4.5))
        a.loglog(kx[1:], Eu[1:], lw=1.2)
        a.set_xlabel("k [1/m]")
        a.set_ylabel("E(k)")
        a.set_title("streamwise energy spectrum (first snapshot)")
        a.grid(alpha=0.3, which="both")
        save_fig(fig, "spectrum.png")
        lines += ["## Spatial spectrum", "", "![spectrum](spectrum.png)",
                  ""]
    except Exception as e:  # tiny grids
        print(f"spectrum skipped: {e}", file=sys.stderr)

    if u.shape[0] >= 3:
        pod = compute_pod(u, v, n_modes=min(6, u.shape[0] - 1))
        fig, a = plt.subplots(figsize=(6, 4))
        a.bar(np.arange(pod.energy_fraction.size),
              100 * pod.energy_fraction, color="#4c78a8")
        a.set_xlabel("POD mode")
        a.set_ylabel("energy [%]")
        a.spines[["top", "right"]].set_visible(False)
        save_fig(fig, "pod.png")
        lines += ["## POD energies", "", "![pod](pod.png)", ""]

    if args.rho:
        with np.errstate(invalid="ignore"):
            uu = np.nan_to_num(np.nanmean((u - mu)**2, axis=0))
            vv = np.nan_to_num(np.nanmean((v - mv)**2, axis=0))
            uv = np.nan_to_num(np.nanmean((u - mu) * (v - mv), axis=0))
        P = mean_pressure_rans(mu, mv, uu, vv, uv, dx, dy, rho=args.rho)
        fig, a = plt.subplots(figsize=(6, 4.5))
        im = a.pcolormesh(x, y, P, cmap="magma", shading="auto")
        fig.colorbar(im, ax=a, label="P [Pa]")
        a.set_title("mean (RANS) gauge pressure")
        a.set_aspect("equal")
        save_fig(fig, "pressure.png")
        lines += ["## Mean pressure", "",
                  f"rho = {args.rho:g} kg/m^3, range "
                  f"[{P.min():.6g}, {P.max():.6g}] Pa",
                  "", "![pressure](pressure.png)", ""]

    path = os.path.join(out, "report.md")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"report: {path} (+ {len(figs)} figures)")
    return 0


def cmd_multidt(args) -> int:
    """Multi-frame (multi-Δt) analysis of a time-resolved folder
    (models/multidt.py): each window keeps the largest usable frame
    separation, boosting slow-flow dynamic range."""
    import glob
    import os

    import numpy as np

    from .io.decode import imread_gray
    from .config import PIVConfig
    from .models.multidt import MultiDtPIV
    from .ops.geometry import get_coordinates
    from .utils.persistence import natural_keys, save_binary

    files = sorted(glob.glob(os.path.join(args.folder, f"*{args.file_fmt}")),
                   key=natural_keys)
    if args.max_frames:
        files = files[: args.max_frames]
    seps = sorted(int(s) for s in args.separations.split(","))
    if len(files) <= seps[-1]:
        print(f"need > {seps[-1]} frames, found {len(files)}"
              + (" after --max-frames" if args.max_frames else ""),
              file=sys.stderr)
        return 1
    device = _device(args)
    frames = []
    for f in files:
        a = imread_gray(f)
        if a is None:
            print(f"{f}: unreadable, aborting", file=sys.stderr)
            return 1
        frames.append(a)
    frames = np.stack(frames)

    cfg = PIVConfig(frame_shape=frames.shape[1:], wind_size=args.wind_size,
                    overlap=args.overlap, multipass=args.multipass)
    mdt = MultiDtPIV(cfg, separations=seps, device=device)
    x, y = get_coordinates(frames.shape[1:], *cfg.pass_schedule()[-1])
    n_out = frames.shape[0] - seps[-1]
    for t in range(n_out):
        res = mdt(frames, t)
        frac = {k: float((res.dt_map == k).mean()) for k in seps}
        print(f"t {t}: dt usage " +
              "  ".join(f"{k}f {frac[k]:.0%}" for k in seps) +
              f"  invalid {res.invalid.mean():.1%}")
        if args.out:
            save_binary(f"multidt_{t:04d}.npy", args.out,
                        {"x": x.astype(np.float64),
                         "y": y.astype(np.float64),
                         "u": res.u, "v": res.v,
                         "dt": res.dt_map.astype(np.float64)})
    if args.out:
        print(f"{n_out} merged fields written to {args.out} "
              f"(u/v in px/frame)")
    return 0


def cmd_compare(args) -> int:
    """Compare two saved field tables (or [4,R,C]/.npy binaries) on the
    same grid: per-component bias, RMS and max difference, correlation,
    and the fraction of vectors within ``--tol``.  For validating a run
    against another tool or another configuration."""
    import numpy as np

    def _load(path):
        if path.endswith(".npy"):
            arr = np.load(path)
            if arr.ndim != 3 or arr.shape[0] < 4:
                print(f"{path}: not a [4, R, C] pair file", file=sys.stderr)
                return None
            return {"x": arr[0], "y": arr[1], "u": arr[2], "v": arr[3]}
        from .utils.persistence import load_table

        t = load_table(path)
        keys = list(t)
        # saved tables lead with x, y then the two velocity components
        if len(keys) < 4:
            print(f"{path}: fewer than 4 columns", file=sys.stderr)
            return None
        return {"x": t[keys[0]], "y": t[keys[1]],
                "u": t[keys[2]], "v": t[keys[3]]}

    ta, tb = _load(args.table_a), _load(args.table_b)
    if ta is None or tb is None:
        return 1
    if ta["u"].shape != tb["u"].shape:
        print(f"grid mismatch: {ta['u'].shape} vs {tb['u'].shape}",
              file=sys.stderr)
        return 1
    rc = 0
    for comp in ("u", "v"):
        a, b = np.asarray(ta[comp], float), np.asarray(tb[comp], float)
        both = np.isfinite(a) & np.isfinite(b)
        n = int(both.sum())
        if n == 0:
            print(f"{comp}: no overlapping valid vectors", file=sys.stderr)
            rc = 1
            continue
        d = a[both] - b[both]
        if np.std(a[both]) > 0 and np.std(b[both]) > 0:
            corr = float(np.corrcoef(a[both], b[both])[0, 1])
        else:
            corr = float("nan")
        print(f"{comp}: n {n}  bias {d.mean():+.6g}  "
              f"rms {np.sqrt((d**2).mean()):.6g}  max|d| {np.abs(d).max():.6g}  "
              f"corr {corr:.6f}  within tol {(np.abs(d) <= args.tol).mean():.1%}")
        only_a = int((np.isfinite(a) & ~np.isfinite(b)).sum())
        only_b = int((~np.isfinite(a) & np.isfinite(b)).sum())
        if only_a or only_b:
            print(f"{comp}: valid only in A: {only_a}, only in B: {only_b}")
    return rc


def cmd_ptv(args) -> int:
    """PIV-guided particle tracking over a folder (models/ptv.py).
    Scattered per-particle vectors as ``ptv_<pair>.txt`` tables; columns
    follow the pipeline's unit/sign contract (pipeline.py finalize tail:
    the field is flipped to physical y-up and v negated, so here
    ``y[mm] = (H-1-y_img)*scale`` and ``Vy = -v``), plus the matching
    residual in px."""
    import numpy as np

    from .config import PIVConfig
    from .io.dataset import PIVDataset
    from .models.ptv import PTV
    from .utils.persistence import save_table

    if args.link and args.folder_mode != "sequential":
        print("--link expects --folder-mode sequential (pair i must "
              "connect frames i -> i+1)", file=sys.stderr)
        return 1
    ds = PIVDataset(args.folder, args.file_fmt, folder_mode=args.folder_mode)
    if len(ds) == 0:
        print("no pairs found", file=sys.stderr)
        return 1
    device = _device(args)
    ptv = None
    n_done = 0
    link_results = []
    prev_i, prev_res = None, None
    n = len(ds) if args.pairs is None else min(len(ds), args.pairs)
    for i in range(n):
        fa, fb = ds[i]
        if fa is None:
            print(f"pair {i}: unreadable, skipped", file=sys.stderr)
            continue
        if ptv is None:
            cfg = None
            if not args.no_piv:
                cfg = PIVConfig(frame_shape=fa.shape,
                                wind_size=args.wind_size,
                                overlap=args.overlap,
                                multipass=args.multipass)
            ptv = PTV(fa.shape, piv_config=cfg,
                      max_particles=args.max_particles,
                      min_distance=args.min_distance,
                      smooth_sigma=args.smooth_sigma,
                      search_radius=args.search_radius,
                      frame_mask=args.mask, device=device)
        # sequential series: the previous pair's tracks predict this
        # pair's matching (engine-free guidance; only frame-adjacent)
        prev = (prev_res if args.folder_mode == "sequential"
                and prev_i == i - 1 else None)
        res = ptv(fa, fb, prev=prev)
        prev_i, prev_res = i, res
        print(f"pair {i}: {res.n_a}/{res.n_b} particles detected, "
              f"{res.x.size} tracked "
              f"({res.x.size / max(res.n_a, 1):.0%}), "
              f"median residual {np.median(res.residual) if res.residual.size else 0:.2f} px")
        if args.out:
            k = args.scale / args.dt * 1000.0
            save_table(f"ptv_{i:04d}.txt", args.out, {
                "x[mm]": res.x * args.scale,
                "y[mm]": (fa.shape[0] - 1 - res.y) * args.scale,
                "Vx[m/s]": res.u * k,
                "Vy[m/s]": -res.v * k,
                "residual[px]": res.residual,
            })
            if args.grid:
                from .models.ptv import bin_to_grid

                gx, gy, gu, gv, cnt = bin_to_grid(
                    res.x, res.y, res.u, res.v, fa.shape,
                    wind_size=args.grid, overlap=args.grid // 2)
                save_table(f"ptv_grid_{i:04d}.txt", args.out, {
                    "x[mm]": gx * args.scale,
                    "y[mm]": gy * args.scale,
                    "Vx[m/s]": np.flip(gu, axis=0) * k,
                    "Vy[m/s]": -np.flip(gv, axis=0) * k,
                    "n[1]": np.flip(cnt, axis=0).astype(np.float64),
                })
        n_done += 1
        if args.link:
            link_results.append((i, res, fa.shape[0]))
    if args.link and n_done:
        from .models.ptv import link_trajectories

        h = link_results[0][2]
        # skipped (unreadable) pairs leave index gaps; the linker closes
        # open tracks there instead of joining across the hole
        tracks = link_trajectories([r for _, r, _ in link_results],
                                   min_length=args.min_length,
                                   pair_indices=[p for p, _, _
                                                 in link_results])
        lens = np.array([len(t) for t in tracks]) if tracks else np.zeros(0)
        print(f"{len(tracks)} trajectories (>= {args.min_length} samples); "
              f"longest {int(lens.max()) if lens.size else 0}, "
              f"mean {lens.mean() if lens.size else 0:.1f}")
        if args.out and tracks:
            cols = {"track[1]": [], "frame[1]": [], "x[mm]": [], "y[mm]": []}
            for tid, trk in enumerate(tracks):
                cols["track[1]"].extend([float(tid)] * len(trk))
                cols["frame[1]"].extend(trk.frames.astype(float))
                cols["x[mm]"].extend(trk.x * args.scale)
                cols["y[mm]"].extend((h - 1 - trk.y) * args.scale)
            save_table("ptv_tracks.txt", args.out,
                       {k: np.asarray(v) for k, v in cols.items()})
            from .utils.persistence import save_vtk_tracks

            save_vtk_tracks("ptv_tracks.vtk", args.out, tracks,
                            scale=args.scale, frame_height=h)
            print(f"trajectories written to {args.out} "
                  f"(ptv_tracks.txt + .vtk)")
    if args.out and n_done:
        print(f"{n_done} scattered-vector tables written to {args.out}")
    return 0 if n_done else 1


def cmd_turbulence(args) -> int:
    """Turbulence-scale report over saved per-pair fields
    (stats/turbulence.py).  Saved fields carry u/v in m/s and x/y in mm;
    with ``--nu`` in m^2/s the report is in SI units."""
    import numpy as np

    from .stats.temporal import load_pair_stack
    from .stats.turbulence import turbulence_report
    from .utils.persistence import save_table

    try:
        stack = load_pair_stack(args.folder)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    x, y = stack["x"], stack["y"]
    dx = abs(float(x[0, 1] - x[0, 0])) / 1000.0
    dy = abs(float(y[1, 0] - y[0, 0])) / 1000.0
    rep = turbulence_report(stack["u"], stack["v"], nu=args.nu,
                            dx=dx, dy=dy)
    print(f"{stack['u'].shape[0]} snapshots, grid step "
          f"{dx*1000:g} x {dy*1000:g} mm, nu {args.nu:g} m^2/s")
    print(f"TKE              {rep['tke']:.6g} m^2/s^2")
    print(f"u_rms            {rep['u_rms']:.6g} m/s")
    print(f"dissipation      {rep['dissipation']:.6g} m^2/s^3")
    print(f"Kolmogorov eta   {rep['eta']:.6g} m   "
          f"(tau {rep['tau_eta']:.6g} s)")
    print(f"Taylor lambda    {rep['taylor_microscale']:.6g} m   "
          f"(Re_lambda {rep['re_lambda']:.4g})")
    print(f"integral length  {rep['integral_length']:.6g} m")
    ratio = rep["resolution_dx_over_eta"]
    print(f"resolution dx/eta {ratio:.3g}"
          + ("  [dissipative scales under-resolved: direct estimate "
             "is a lower bound]" if ratio > 3 else ""))
    if args.out:
        out = save_table("turbulence_report.txt", args.out,
                         {f"{k}[SI]": np.array([v])
                          for k, v in rep.items()})
        print(f"wrote {out}")
    return 0


def cmd_dmd(args) -> int:
    """Dynamic mode decomposition of saved per-pair fields (stats/dmd.py;
    frequency-resolved companion to ``tpiv-torch pod``).  Input: a folder of
    ``[4, R, C]`` per-pair binaries from a time-resolved run."""
    import numpy as np

    from .stats.dmd import compute_dmd
    from .stats.temporal import load_pair_stack
    from .utils.persistence import save_binary, save_table

    try:
        stack = load_pair_stack(args.folder)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    u, v = stack["u"], stack["v"]
    if u.shape[0] < 3:
        print("need >= 3 saved pair files for DMD", file=sys.stderr)
        return 1
    try:
        d = compute_dmd(u, v, dt=1.0 / args.fs, rank=args.rank,
                        subtract_mean=not args.keep_mean)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"{u.shape[0]} snapshots @ {args.fs:g} Hz, "
          f"{d.eigenvalues.size} modes (rank "
          f"{'auto' if args.rank is None else args.rank})")
    shown = 0
    for m in range(d.eigenvalues.size):
        if d.frequencies[m] < 0:  # conjugate twin — not physical
            continue
        print(f"mode {m}: f {d.frequencies[m]:.4g} Hz, "
              f"growth {d.growth_rates[m]:+.4g} 1/s, "
              f"|amp| {abs(d.amplitudes[m]):.4g}")
        shown += 1
        if shown >= args.modes:
            break
    if args.out:
        x, y = stack["x"], stack["y"]
        shown = 0
        for m in range(d.eigenvalues.size):
            if d.frequencies[m] < 0:
                continue
            save_binary(f"dmd_mode{m}.npy", args.out,
                        {"x": x, "y": y,
                         "u_re": d.modes_u[m].real,
                         "u_im": d.modes_u[m].imag,
                         "v_re": d.modes_v[m].real,
                         "v_im": d.modes_v[m].imag})
            shown += 1
            if shown >= args.modes:
                break
        save_table("dmd_spectrum.txt", args.out, {
            "f[Hz]": d.frequencies,
            "growth[1/s]": d.growth_rates,
            "amp[1]": np.abs(d.amplitudes),
            "eig_re[1]": d.eigenvalues.real,
            "eig_im[1]": d.eigenvalues.imag,
        })
        print(f"mode fields + spectrum written to {args.out}")
    return 0


def cmd_pressure(args) -> int:
    """Pressure reconstruction from saved fields (stats/pressure.py; a
    standard PIV post-processing step the reference lacks).  Input: a
    folder of ``[4, R, C]`` per-pair binaries (or one ``.npy`` file).
    Default: per-snapshot pressure from the steady Poisson problem;
    ``--fs`` adds the unsteady boundary term for time-resolved runs;
    ``--mode mean`` solves the Reynolds-averaged problem from the
    ensemble mean + stresses.  Saved fields carry x, y in mm and u, v in
    m/s, so with ``--rho`` in kg/m^3 the output is gauge pressure in Pa.
    """
    import os

    import numpy as np

    from .stats.pressure import (mean_pressure_rans, pressure_from_stack,
                                 pressure_poisson)
    from .stats.temporal import load_pair_stack
    from .utils.persistence import save_binary, save_table

    if os.path.isfile(args.path):
        arr = np.load(args.path)
        if arr.ndim != 3 or arr.shape[0] != 4:
            print(f"{args.path}: not a [4, R, C] pair file", file=sys.stderr)
            return 1
        stack = {"x": arr[0], "y": arr[1],
                 "u": arr[2][None], "v": arr[3][None]}
    else:
        try:
            # steady snapshot-wise pressure works from a single pair file
            stack = load_pair_stack(args.path, min_snapshots=1)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
    x, y, u, v = stack["x"], stack["y"], stack["u"], stack["v"]

    # saved grids are in mm (pipeline tail: x*scale); solve in metres so
    # rho [kg/m^3] and u [m/s] give Pa.  Normalise to ascending axes —
    # the solver needs positive spacings.
    dx = float(x[0, 1] - x[0, 0]) / 1000.0
    dy = float(y[1, 0] - y[0, 0]) / 1000.0
    flip_r, flip_c = dy < 0, dx < 0
    if flip_r:
        u, v, dy = u[:, ::-1], v[:, ::-1], -dy
    if flip_c:
        u, v, dx = u[..., ::-1], v[..., ::-1], -dx
    if dx <= 0 or dy <= 0:
        print("degenerate coordinate grids", file=sys.stderr)
        return 1

    def restore(p):
        if flip_r:
            p = p[::-1]
        if flip_c:
            p = p[:, ::-1]
        return p

    if args.mode == "mean":
        with np.errstate(invalid="ignore"):
            mu, mv = np.nanmean(u, axis=0), np.nanmean(v, axis=0)
            uu = np.nanmean((u - mu)**2, axis=0)
            vv = np.nanmean((v - mv)**2, axis=0)
            uv = np.nanmean((u - mu) * (v - mv), axis=0)
        p = restore(mean_pressure_rans(
            *(np.nan_to_num(a) for a in (mu, mv, uu, vv, uv)),
            dx, dy, rho=args.rho))
        print(f"mean pressure from {u.shape[0]} snapshots: "
              f"range [{p.min():.6g}, {p.max():.6g}] Pa, "
              f"rms {np.sqrt((p**2).mean()):.6g} Pa")
        if args.out:
            save_binary("pressure_mean.npy", args.out,
                        {"x": x, "y": y, "p": p})
            out = save_table("pressure_mean.txt", args.out,
                             {"x[mm]": x, "y[mm]": y, "p[Pa]": p})
            print(f"wrote {out}")
        return 0

    if args.fs and u.shape[0] >= 2:
        ps = pressure_from_stack(u, v, 1.0 / args.fs, dx, dy,
                                 rho=args.rho, nu=args.nu)
        kind = f"time-resolved @ {args.fs:g} Hz"
    else:
        if args.fs:
            print("--fs ignored: need >= 2 snapshots for the unsteady term",
                  file=sys.stderr)
        ps = np.stack([pressure_poisson(u[i], v[i], dx, dy,
                                        rho=args.rho, nu=args.nu)
                       for i in range(u.shape[0])])
        kind = "steady (snapshot-wise)"
    ps = np.stack([restore(p) for p in ps])
    rms = np.sqrt((ps**2).mean(axis=(1, 2)))
    print(f"{ps.shape[0]} snapshot(s), {kind}: "
          f"rms gauge pressure {rms.mean():.6g} Pa "
          f"(min {rms.min():.6g}, max {rms.max():.6g})")
    if args.out:
        for i in range(ps.shape[0]):
            save_binary(f"pressure_{i:04d}.npy", args.out,
                        {"x": x, "y": y, "p": ps[i]})
        print(f"{ps.shape[0]} pressure fields written to {args.out}")
    return 0


def cmd_calib(args) -> int:
    """Fit a Soloff camera mapping (calib/mapping.py) from calibration
    input and save it as ``.npz`` — the per-camera step of the stereo
    workflow (beyond the reference, which is single-camera pixel-units
    only).  Input is either dot-target images at known plane heights
    (``--target img.bmp:z``, repeatable) or explicit point files
    (``--points pts.csv`` with columns x,y,z,X,Y)."""
    import numpy as np

    from .calib import CameraMapping, detect_dot_grid

    worlds, images = [], []
    for spec in args.target or []:
        path, _, ztxt = spec.rpartition(":")
        if not path:
            print(f"--target {spec!r}: expected 'image.bmp:z'",
                  file=sys.stderr)
            return 1
        from .io.decode import imread_gray

        frame = imread_gray(path)
        if frame is None:
            print(f"cannot read {path}", file=sys.stderr)
            return 1
        try:
            w, im = detect_dot_grid(
                frame, spacing=args.spacing, z=float(ztxt),
                invert=args.invert, min_area=args.min_area)
        except ValueError as e:
            print(f"{path}: {e}", file=sys.stderr)
            return 1
        print(f"{path}: {len(im)} dots at z={float(ztxt):g}")
        worlds.append(w)
        images.append(im)
    for path in args.points or []:
        pts = np.loadtxt(path, delimiter=",", skiprows=args.skiprows)
        if pts.ndim != 2 or pts.shape[1] != 5:
            print(f"{path}: expected 5 columns x,y,z,X,Y", file=sys.stderr)
            return 1
        worlds.append(pts[:, :3])
        images.append(pts[:, 3:])
        print(f"{path}: {len(pts)} points")
    if not worlds:
        print("need --target and/or --points input", file=sys.stderr)
        return 1
    world = np.concatenate(worlds, axis=0)
    image = np.concatenate(images, axis=0)
    m = CameraMapping.fit(world, image)
    if np.ptp(world[:, 2]) == 0:
        print("WARNING: single z plane — mapping cannot resolve "
              "out-of-plane motion (fine for dewarp, not for stereo)",
              file=sys.stderr)
    m.save(args.out)
    print(f"fit {len(world)} points, residual {m.fit_rms_px:.4f} px "
          f"-> {args.out}")
    return 0


def cmd_dewarp(args) -> int:
    """Resample a folder of raw camera frames onto a regular world grid
    (calib/mapping.py dewarp_image).  Run PIV on the dewarped frames and
    displacements are in world units times the grid pitch — the common-
    grid route into stereo reconstruction."""
    import glob
    import os

    import numpy as np

    from .calib import CameraMapping, dewarp_image
    from .io.decode import imread_gray, imwrite_gray
    from .utils.persistence import natural_keys

    m = CameraMapping.load(args.calib)
    files = sorted(glob.glob(os.path.join(args.folder, f"*{args.file_fmt}")),
                   key=natural_keys)
    if not files:
        print(f"no *{args.file_fmt} files in {args.folder}", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    shape = (args.height, args.width)
    for f in files:
        frame = imread_gray(f)
        if frame is None:
            print(f"skipping unreadable {f}", file=sys.stderr)
            continue
        out = dewarp_image(m, frame, args.x0, args.y0, args.pitch,
                           shape, z=args.z,
                           order=3 if args.cubic else 1)
        dst = os.path.join(args.out, os.path.basename(f))
        imwrite_gray(dst, np.clip(np.round(out), 0, 255).astype(np.uint8))
    print(f"{len(files)} frames -> {args.out}  "
          f"(world window x0={args.x0:g} y0={args.y0:g} "
          f"pitch={args.pitch:g}, {args.width}x{args.height})")
    return 0


def cmd_stereo(args) -> int:
    """Two-camera 3C reconstruction (calib/stereo.py) from two saved PIV
    tables computed on each camera's RAW frames.  Writes a world-grid
    table with dx/dy/dz and the per-point 4-equation residual."""
    from .calib import CameraMapping, reconstruct_from_grids
    from .calib.stereo import table_to_px_field
    from .utils.persistence import load_table, save_table, save_vtk

    cam1 = CameraMapping.load(args.calib1)
    cam2 = CameraMapping.load(args.calib2)
    f1 = table_to_px_field(load_table(args.table1), args.scale, args.dt)
    f2 = table_to_px_field(load_table(args.table2), args.scale, args.dt)
    try:
        res = reconstruct_from_grids(
            cam1, cam2, f1, f2, z=args.z,
            shape=tuple(args.shape) if args.shape else None)
    except ValueError as e:
        print(f"stereo reconstruction failed: {e}", file=sys.stderr)
        return 1
    import numpy as np

    valid = np.isfinite(res["dz"])
    print(f"grid {res['x'].shape[0]}x{res['x'].shape[1]}, "
          f"{int(valid.sum())} valid points, "
          f"median residual {np.nanmedian(res['residual']):.4f} px")
    out = save_table(args.out_name, args.out, {
        "x[world]": res["x"], "y[world]": res["y"],
        "dx[world]": res["dx"], "dy[world]": res["dy"],
        "dz[world]": res["dz"], "residual[px]": res["residual"],
    })
    print(f"wrote {out}")
    if args.vtk:
        vtk = save_vtk(args.out_name.rsplit(".", 1)[0] + ".vtk", args.out,
                       res["x"], res["y"], res["dx"], res["dy"],
                       scalars={"dz": res["dz"],
                                "residual": res["residual"]})
        print(f"wrote {vtk}")
    return 0


def cmd_watch(args) -> int:
    """Print new frame pairs as they appear (the working counterpart of the
    reference's standalone watchman.py watchdog script)."""
    from .io.watch import StreamingPairSource

    src = StreamingPairSource(args.folder, args.file_fmt,
                              idle_timeout=args.idle_timeout)
    try:
        for name_a, name_b in src:
            print(f"{name_a} {name_b}", flush=True)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_view(args) -> int:
    """Render a saved PIV table to a PNG (the GUI's open-saved-file flow,
    headless; reference Database.load + PIVcanvas).  Scattered PTV tables
    (``ptv_*.txt`` — no rectangular grid) render as a quiver plot."""
    from .gui import viz
    from .utils.database import Database

    import os

    if os.path.basename(args.table).startswith("ptv_") \
            and "grid" not in os.path.basename(args.table):
        import numpy as np

        with open(args.table) as fh:
            header = fh.readline().strip().split(", ")
            # bail before loadtxt: an empty table would make it warn
            # ("input contained no data") on its way to an empty array
            has_rows = any(line.strip() for line in fh)
        if not has_rows:
            print(f"{args.table}: no rows to render", file=sys.stderr)
            return 1
        data = np.loadtxt(args.table, skiprows=1, delimiter=",", ndmin=2)
        if data.size == 0 or data.shape[1] < len(header):
            print(f"{args.table}: no rows to render", file=sys.stderr)
            return 1
        cols = {k: data[:, i] for i, k in enumerate(header)}
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        base = os.path.basename(args.table).rsplit(".", 1)[0]
        fig, ax = plt.subplots(figsize=(8, 6), dpi=110)
        if all(k in cols for k in ("track[1]", "frame[1]",
                                   "x[mm]", "y[mm]")):
            # linked-trajectory table: one polyline per track
            tids = cols["track[1]"]
            cmap = plt.get_cmap("viridis")
            uniq = np.unique(tids)
            for t in uniq:
                sel = tids == t
                ax.plot(cols["x[mm]"][sel], cols["y[mm]"][sel], "-",
                        lw=0.9, color=cmap(float(t % 97) / 97))
            ax.set_title(f"{base}: {uniq.size} trajectories")
        elif all(k in cols for k in ("x[mm]", "y[mm]",
                                     "Vx[m/s]", "Vy[m/s]")):
            x, y, u, v = (cols[k] for k in
                          ("x[mm]", "y[mm]", "Vx[m/s]", "Vy[m/s]"))
            q = ax.quiver(x, y, u, v, np.hypot(u, v), cmap="viridis",
                          angles="xy")
            fig.colorbar(q, ax=ax, label="|V| [m/s]")
            ax.set_title(base)
        else:
            print(f"not a PTV table (columns {header})", file=sys.stderr)
            return 1
        ax.set_xlabel("x [mm]")
        ax.set_ylabel("y [mm]")
        ax.set_aspect("equal")
        out = args.out or f"{base}_view.png"
        fig.tight_layout()
        fig.savefig(out)
        print(out)
        return 0

    db = Database()
    db.load(args.table)
    data = db.get()
    key = args.field
    if key not in data:
        candidates = [k for k in data if k not in ("x[mm]", "y[mm]")]
        print(f"field {key!r} not in table; available: {candidates}",
              file=sys.stderr)
        return 1
    out = args.out or f"{db.name}_{key[:key.find('[')]}.png".replace("/", "_")
    viz.render_field(
        data, key, streamlines=args.streamlines, vectors=args.vectors,
        out_path=out, vmin=args.vmin, vmax=args.vmax,
    )
    print(out)
    return 0


def cmd_gui(args) -> int:
    from .gui import runGUI

    runGUI()
    return 0


def cmd_settings(args) -> int:
    params = PIVParams.from_json(args.path)
    print(json.dumps(params.__dict__, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The full ``tpiv-torch`` argument parser (exposed for tests/tooling)."""
    parser = argparse.ArgumentParser(
        prog="tpiv-torch", description="PIV engine on PyTorch/CUDA"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="offline analysis of a folder")
    _add_common(p_run)
    p_run.add_argument("--folder-mode", choices=["pairs", "sequential"],
                       default="pairs")
    p_run.add_argument("--batch-size", type=int, default=4)
    p_run.add_argument("--checkpoint", default=None, metavar="PATH",
                       help="checkpoint file: interrupted runs resume by "
                            "pair index with identical statistics")
    p_run.add_argument(
        "--smooth", nargs="?", const="auto", default=None, metavar="S",
        help="robust smoothn post-smoothing of each field "
             "(no value = GCV-chosen parameter, or a fixed float)")
    p_run.add_argument("--checkpoint-every", type=int, default=50,
                       metavar="N", help="pairs between checkpoint writes")
    p_run.add_argument(
        "--shard", default=None, metavar="I/N",
        help="multi-host campaign sharding: process only pair block I of "
             "N (contiguous split of the sorted pair list) and KEEP the "
             "final statistics state at --checkpoint for `tpiv-torch "
             "merge-stats` (requires --checkpoint)")
    p_run.set_defaults(fn=cmd_run)

    p_srv = sub.add_parser(
        "serve", help="long-lived HTTP analysis service (engine stays hot)")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8477)
    p_srv.add_argument("--device", default="auto")
    p_srv.add_argument("--wind-size", type=int, default=64)
    p_srv.add_argument("--overlap", type=int, default=32)
    p_srv.add_argument("--multipass", type=int, default=2)
    p_srv.add_argument("--multipass-mode", default="CWS",
                       choices=["CWS", "DWS", "DEF"])
    p_srv.add_argument("--multipass-scale", type=float, default=2.0)
    p_srv.add_argument("--dt", type=float, default=1.0)
    p_srv.add_argument("--scale", type=float, default=1.0)
    p_srv.add_argument("--no-validate", action="store_true")
    p_srv.add_argument("--engine-option", action="append", metavar="K=V",
                       help="extra PIVConfig field (repeatable), e.g. "
                            "--engine-option median_filter=normmedian")
    p_srv.add_argument("--warmup", default=None, metavar="HxW",
                       help="warm the engine for this frame shape before "
                            "listening")
    p_srv.set_defaults(fn=cmd_serve)

    p_merge = sub.add_parser(
        "merge-stats",
        help="merge shard statistics states into one statistics table")
    p_merge.add_argument("states", nargs="+",
                         help="shard checkpoint .npz files (tpiv-torch run "
                              "--shard)")
    p_merge.add_argument("--save-dir", default="./Out")
    p_merge.add_argument("--name", default="merged",
                         help="output base name (<name>_statistics.txt)")
    p_merge.add_argument("--allow-partial", action="store_true",
                         help="merge states from interrupted shards too "
                              "(default: refuse, to avoid silently "
                              "under-counted campaign statistics)")
    p_merge.set_defaults(fn=cmd_merge_stats)

    p_on = sub.add_parser("online", help="streaming analysis of a growing folder")
    _add_common(p_on)
    p_on.add_argument("--idle-timeout", type=float, default=None)
    p_on.add_argument(
        "--frame-shape", default=None, metavar="HxW",
        help="camera geometry hint, e.g. 2048x2048: build the engine and "
             "warm it while waiting for the first frame instead of inline "
             "when it lands")
    p_on.set_defaults(fn=cmd_online)

    p_watch = sub.add_parser("watch", help="print new frame pairs as they appear")
    p_watch.add_argument("folder")
    p_watch.add_argument("--file-fmt", default=".bmp")
    p_watch.add_argument("--idle-timeout", type=float, default=None)
    p_watch.set_defaults(fn=cmd_watch)

    p_view = sub.add_parser("view", help="render a saved PIV table to PNG")
    p_view.add_argument("table", help="saved statistics/pair .txt table")
    p_view.add_argument("--field", default="Vy[m/s]")
    p_view.add_argument("--out", default=None)
    p_view.add_argument("--streamlines", action="store_true")
    p_view.add_argument("--vectors", action="store_true",
                        help="decimated quiver overlay")
    p_view.add_argument("--vmin", type=float, default=None)
    p_view.add_argument("--vmax", type=float, default=None)
    p_view.set_defaults(fn=cmd_view)

    p_gui = sub.add_parser("gui", help="launch the Qt GUI (requires PyQt5)")
    p_gui.set_defaults(fn=cmd_gui)

    p_set = sub.add_parser("settings", help="print current settings.json")
    p_set.add_argument("--path", default=None)
    p_set.set_defaults(fn=cmd_settings)

    p_vid = sub.add_parser("video", help="PIV over a video file's frames")
    p_vid.add_argument("video", help="video file (any OpenCV-readable codec)")
    p_vid.add_argument("--pairing", choices=["pairs", "sequential"],
                       default="sequential",
                       help="frame pairing: (0,1),(2,3).. or (0,1),(1,2)..")
    p_vid.add_argument("--wind-size", type=int, default=64)
    p_vid.add_argument("--overlap", type=int, default=32)
    p_vid.add_argument("--multipass", type=int, default=1)
    p_vid.add_argument("--multipass-mode", choices=["CWS", "DWS", "DEF"],
                       default="CWS")
    p_vid.add_argument("--multipass-scale", type=float, default=2.0)
    p_vid.add_argument("--scale", type=float, default=1.0)
    p_vid.add_argument("--dt", type=float, default=1.0)
    p_vid.add_argument("--device", default="auto")
    p_vid.add_argument("--batch-size", type=int, default=4)
    p_vid.add_argument("--max-pairs", type=int, default=None)
    p_vid.add_argument("--no-validate", action="store_true")
    p_vid.add_argument("--save", choices=["Dont save", "Save statistics"],
                       default="Save statistics", dest="save_opt")
    p_vid.add_argument("--save-dir", default="./Out")
    p_vid.add_argument("-v", "--verbose", action="store_true")
    p_vid.set_defaults(fn=cmd_video)

    p_bench = sub.add_parser("bench", help="run the headline benchmark")
    p_bench.set_defaults(fn=cmd_bench)

    p_doc = sub.add_parser(
        "doctor", help="environment self-check (devices, cache, decoder, "
                       "bandwidth, engine smoke test)")
    p_doc.add_argument("--device", default="auto")
    p_doc.add_argument("--no-engine", action="store_true",
                       help="skip the engine smoke test (fast, no build)")
    p_doc.add_argument("--bandwidth-mb", type=int, default=64,
                       help="host->device probe size in MB")
    p_doc.add_argument("--cache", action="store_true",
                       help="also prove the cross-process build-cache "
                            "round-trip (two fresh subprocesses; the "
                            "second must build nothing)")
    p_doc.set_defaults(fn=cmd_doctor)

    p_warm = sub.add_parser(
        "warmup", help="build the kernels into the build cache and run "
                       "the engine once")
    p_warm.add_argument("frame", help="frame shape HxW, e.g. 2048x2048")
    p_warm.add_argument("--wind-size", type=int, default=64)
    p_warm.add_argument("--overlap", type=int, default=32)
    p_warm.add_argument("--multipass", type=int, default=1)
    p_warm.add_argument("--multipass-mode",
                        choices=["CWS", "DWS", "DEF"], default="CWS")
    p_warm.add_argument("--multipass-scale", type=float, default=2.0)
    p_warm.add_argument("--batch-size", type=int, default=4,
                        help="the run's batch size (its first batch of "
                             "min(4, B) pairs runs too)")
    p_warm.add_argument("--device", default="auto")
    p_warm.set_defaults(fn=cmd_warmup)

    p_ens = sub.add_parser(
        "ensemble",
        help="correlation-averaged (ensemble) PIV: ONE field from a whole "
             "folder, for sparse micro-PIV seeding")
    p_ens.add_argument("folder", help="folder of frame images")
    p_ens.add_argument("--file-fmt", default=".bmp")
    p_ens.add_argument("--folder-mode", choices=["pairs", "sequential"],
                       default="pairs")
    p_ens.add_argument("--wind-size", type=int, default=32)
    p_ens.add_argument("--overlap", type=int, default=16)
    p_ens.add_argument("--scale", type=float, default=1.0,
                       help="mm per pixel")
    p_ens.add_argument("--dt", type=float, default=1.0,
                       help="frame interval, us")
    p_ens.add_argument("--device", default="auto")
    p_ens.add_argument("--batch-size", type=int, default=8)
    p_ens.add_argument("--no-validate", action="store_true")
    p_ens.add_argument("--window-weight", choices=["none", "gaussian"],
                       default="none")
    p_ens.add_argument("--correlation", choices=["scc", "rpc"],
                       default="scc")
    p_ens.add_argument("--rpc-diameter", type=float, default=2.8)
    p_ens.add_argument("--preprocess", choices=["none", "clahe", "stretch"],
                       default="none")
    p_ens.add_argument("--background", choices=["none", "auto"],
                       default="none")
    p_ens.add_argument("--out", default="./Out", metavar="DIR")
    p_ens.set_defaults(fn=cmd_ensemble)

    p_exp = sub.add_parser(
        "export", help="convert a saved result to VTK (ParaView), "
                       "MATLAB .mat or HDF5")
    p_exp.add_argument("result", help="saved _statistics.txt / pair .txt "
                                      "table or [4,R,C] pair .npy")
    p_exp.add_argument("--out", default=".", metavar="DIR")
    p_exp.add_argument("--format", default="vtk",
                       choices=("vtk", "mat", "h5"),
                       help="output format (default vtk)")
    p_exp.add_argument("--derived", action="store_true",
                       help="attach vorticity/swirl/divergence/Okubo-Weiss "
                            "point scalars")
    p_exp.set_defaults(fn=cmd_export)

    p_pod = sub.add_parser(
        "pod", help="snapshot POD of saved per-pair binary fields")
    p_pod.add_argument("folder")
    p_pod.add_argument("--modes", type=int, default=8,
                       help="number of modes to report (default 8)")
    p_pod.add_argument("--out", default=None, metavar="DIR",
                       help="write mode fields + temporal coefficients here")
    p_pod.set_defaults(fn=cmd_pod)

    p_spod = sub.add_parser(
        "spod",
        help="spectral POD of a time-resolved saved-field sequence")
    p_spod.add_argument("folder")
    p_spod.add_argument("--fs", type=float, required=True,
                        help="field sampling rate in Hz")
    p_spod.add_argument("--n-fft", type=int, default=None,
                        help="Welch block length (default: auto)")
    p_spod.add_argument("--overlap", type=float, default=0.5)
    p_spod.add_argument("--modes", type=int, default=3,
                        help="modes kept per frequency (default 3)")
    p_spod.add_argument("--peaks", type=int, default=5,
                        help="spectral peaks to report/save (default 5)")
    p_spod.add_argument("--out", default=None, metavar="DIR",
                        help="write spectrum table + peak mode fields here")
    p_spod.set_defaults(fn=cmd_spod)

    p_qc = sub.add_parser(
        "qc", help="measurement-quality report (SNR map, peak locking)")
    p_qc.add_argument("folder")
    p_qc.add_argument("--file-fmt", default=".bmp")
    p_qc.add_argument("--folder-mode", choices=["pairs", "sequential"],
                      default="pairs")
    p_qc.add_argument("--wind-size", type=int, default=64)
    p_qc.add_argument("--overlap", type=int, default=32)
    p_qc.add_argument("--val-ratio", type=float, default=1.2)
    p_qc.add_argument("--pairs", type=int, default=4,
                      help="max pairs to scan (default 4)")
    p_qc.add_argument("--device", default="auto")
    p_qc.set_defaults(fn=cmd_qc)

    p_tmp = sub.add_parser(
        "temporal", help="time-resolved analysis of saved binary fields")
    p_tmp.add_argument("folder", help="folder of [4,R,C] .npy pair files")
    p_tmp.add_argument("--fs", type=float, default=1.0,
                       help="pair acquisition rate, Hz")
    p_tmp.add_argument("--point", action="append", metavar="R,C",
                       help="probe grid index (repeatable; default centre)")
    p_tmp.add_argument("--nperseg", type=int, default=None,
                       help="Welch segment length (default min(256, T))")
    p_tmp.add_argument("--phase-bins", type=int, default=None,
                       help="phase-average into N bins (phase from the "
                            "first probe's u series)")
    p_tmp.add_argument("--out", default=None, metavar="DIR",
                       help="write PSD + running-mean tables here")
    p_tmp.set_defaults(fn=cmd_temporal)

    p_dns = sub.add_parser(
        "dense",
        help="dense Lucas-Kanade (FOLKI-style) analysis of a folder")
    p_dns.add_argument("folder", help="folder of frame images")
    p_dns.add_argument("--file-fmt", default=".bmp")
    p_dns.add_argument("--folder-mode", choices=["pairs", "sequential"],
                       default="pairs")
    p_dns.add_argument("--pairs", type=int, default=None)
    p_dns.add_argument("--wind-size", type=int, default=32,
                       help="output-grid window (LK radius = this/4)")
    p_dns.add_argument("--overlap", type=int, default=16)
    p_dns.add_argument("--hybrid", action="store_true",
                       help="anchor on the correlation engine "
                            "(predictor-corrector: full capture range "
                            "+ LK precision)")
    p_dns.add_argument("--iters", type=int, default=8)
    p_dns.add_argument("--levels", type=int, default=3)
    p_dns.add_argument("--scale", type=float, default=1.0,
                       help="mm per pixel")
    p_dns.add_argument("--dt", type=float, default=1.0,
                       help="frame interval, us")
    p_dns.add_argument("--out", default=None, metavar="DIR")
    p_dns.add_argument("--device", default="auto")
    p_dns.set_defaults(fn=cmd_dense)

    p_rep = sub.add_parser(
        "report",
        help="one-command campaign report (markdown + figures) from "
             "saved fields")
    p_rep.add_argument("folder", help="folder of [4,R,C] .npy pair files")
    p_rep.add_argument("--fs", type=float, default=1.0,
                       help="pair acquisition rate, Hz")
    p_rep.add_argument("--nu", type=float, default=1e-6,
                       help="kinematic viscosity, m^2/s")
    p_rep.add_argument("--rho", type=float, default=None,
                       help="fluid density, kg/m^3 — adds the mean "
                            "pressure section")
    p_rep.add_argument("--out", default=None, metavar="DIR",
                       help="report directory (default FOLDER/report)")
    p_rep.set_defaults(fn=cmd_report)

    p_mdt = sub.add_parser(
        "multidt",
        help="multi-frame (multi-dt) analysis of a time-resolved folder")
    p_mdt.add_argument("folder", help="folder of sequential frames")
    p_mdt.add_argument("--file-fmt", default=".bmp")
    p_mdt.add_argument("--separations", default="1,2,4",
                       help="comma-separated frame separations "
                            "(default 1,2,4)")
    p_mdt.add_argument("--wind-size", type=int, default=64)
    p_mdt.add_argument("--overlap", type=int, default=32)
    p_mdt.add_argument("--multipass", type=int, default=1)
    p_mdt.add_argument("--max-frames", type=int, default=None,
                       help="process at most this many frames")
    p_mdt.add_argument("--out", default=None, metavar="DIR",
                       help="write merged [5,R,C] fields here "
                            "(x, y, u, v, dt)")
    p_mdt.add_argument("--device", default="auto")
    p_mdt.set_defaults(fn=cmd_multidt)

    p_cmp = sub.add_parser(
        "compare", help="diff two saved field tables on the same grid")
    p_cmp.add_argument("table_a", help="saved table .txt or [4,R,C] .npy")
    p_cmp.add_argument("table_b")
    p_cmp.add_argument("--tol", type=float, default=10.0,
                       help="per-vector agreement tolerance in the "
                            "tables' velocity units (default 10)")
    p_cmp.set_defaults(fn=cmd_compare)

    p_ptv = sub.add_parser(
        "ptv", help="particle tracking (scattered per-particle vectors)")
    p_ptv.add_argument("folder", help="folder of frame images")
    p_ptv.add_argument("--file-fmt", default=".bmp")
    p_ptv.add_argument("--folder-mode", choices=["pairs", "sequential"],
                       default="pairs")
    p_ptv.add_argument("--pairs", type=int, default=None,
                       help="max pairs to process (default all)")
    p_ptv.add_argument("--no-piv", action="store_true",
                       help="plain nearest-neighbour tracking (skip the "
                            "PIV predictor)")
    p_ptv.add_argument("--wind-size", type=int, default=64,
                       help="predictor PIV window (default 64)")
    p_ptv.add_argument("--overlap", type=int, default=32)
    p_ptv.add_argument("--multipass", type=int, default=2)
    p_ptv.add_argument("--max-particles", type=int, default=4096)
    p_ptv.add_argument("--min-distance", type=int, default=3,
                       help="non-maximum-suppression radius, px")
    p_ptv.add_argument("--smooth-sigma", type=float, default=1.3,
                       help="matched-filter width, px (~diameter/2.35)")
    p_ptv.add_argument("--search-radius", type=float, default=None,
                       help="match radius, px (default 4 guided / 10 plain)")
    p_ptv.add_argument("--scale", type=float, default=1.0,
                       help="mm per pixel")
    p_ptv.add_argument("--dt", type=float, default=1.0,
                       help="frame interval, us")
    p_ptv.add_argument("--mask", default=None, metavar="IMG",
                       help="ROI mask image (non-zero = excluded), same "
                            "contract as tpiv-torch run --mask")
    p_ptv.add_argument("--link", action="store_true",
                       help="link pairs into Lagrangian trajectories "
                            "(sequential folder mode) -> ptv_tracks.txt")
    p_ptv.add_argument("--min-length", type=int, default=3,
                       help="minimum trajectory samples with --link "
                            "(default 3)")
    p_ptv.add_argument("--grid", type=int, default=None, metavar="WIN",
                       help="also bin tracks onto the WIN px (50%% overlap) "
                            "PIV grid as ptv_grid_<pair>.txt")
    p_ptv.add_argument("--out", default=None, metavar="DIR",
                       help="write scattered-vector tables here")
    p_ptv.add_argument("--device", default="auto")
    p_ptv.set_defaults(fn=cmd_ptv)

    p_tur = sub.add_parser(
        "turbulence",
        help="turbulence scales (TKE, dissipation, eta, Taylor, L) from "
             "saved fields")
    p_tur.add_argument("folder", help="folder of [4,R,C] .npy pair files")
    p_tur.add_argument("--nu", type=float, default=1e-6,
                       help="kinematic viscosity, m^2/s (default 1e-6 = "
                            "water at 20C)")
    p_tur.add_argument("--out", default=None, metavar="DIR",
                       help="write the report table here")
    p_tur.set_defaults(fn=cmd_turbulence)

    p_dmd = sub.add_parser(
        "dmd", help="dynamic mode decomposition of saved per-pair fields")
    p_dmd.add_argument("folder", help="folder of [4,R,C] .npy pair files")
    p_dmd.add_argument("--fs", type=float, default=1.0,
                       help="pair acquisition rate, Hz (default 1)")
    p_dmd.add_argument("--rank", type=int, default=None,
                       help="SVD truncation rank (default: noise floor)")
    p_dmd.add_argument("--modes", type=int, default=8,
                       help="number of modes to report/save (default 8)")
    p_dmd.add_argument("--keep-mean", action="store_true",
                       help="do not subtract the temporal mean (use for "
                            "transient growth/decay data)")
    p_dmd.add_argument("--out", default=None, metavar="DIR",
                       help="write mode fields + spectrum table here")
    p_dmd.set_defaults(fn=cmd_dmd)

    p_prs = sub.add_parser(
        "pressure",
        help="pressure reconstruction from saved fields (Poisson solve)")
    p_prs.add_argument("path", help="folder of [4,R,C] .npy pair files, "
                                    "or one such file")
    p_prs.add_argument("--rho", type=float, default=1000.0,
                       help="fluid density, kg/m^3 (default 1000 = water)")
    p_prs.add_argument("--nu", type=float, default=0.0,
                       help="kinematic viscosity, m^2/s (boundary term; "
                            "default 0)")
    p_prs.add_argument("--fs", type=float, default=None,
                       help="pair acquisition rate, Hz — adds the unsteady "
                            "term for time-resolved runs")
    p_prs.add_argument("--mode", choices=["snapshot", "mean"],
                       default="snapshot",
                       help="snapshot-wise pressure, or Reynolds-averaged "
                            "mean pressure from the ensemble")
    p_prs.add_argument("--out", default=None, metavar="DIR",
                       help="write pressure fields here")
    p_prs.set_defaults(fn=cmd_pressure)

    p_cal = sub.add_parser(
        "calib", help="fit a Soloff camera mapping from target images/points")
    p_cal.add_argument("--target", action="append", metavar="IMG:Z",
                       help="dot-target image at plane height Z (repeat "
                            "for multiple planes)")
    p_cal.add_argument("--points", action="append", metavar="CSV",
                       help="explicit correspondences: columns x,y,z,X,Y")
    p_cal.add_argument("--spacing", type=float, default=1.0,
                       help="physical dot pitch of the target (world units)")
    p_cal.add_argument("--invert", action="store_true",
                       help="dark dots on a bright target")
    p_cal.add_argument("--min-area", type=int, default=4,
                       help="min dot area in px (noise rejection)")
    p_cal.add_argument("--skiprows", type=int, default=0,
                       help="header rows to skip in --points files")
    p_cal.add_argument("--out", default="camera.npz")
    p_cal.set_defaults(fn=cmd_calib)

    p_dw = sub.add_parser(
        "dewarp", help="resample raw frames onto a regular world grid")
    p_dw.add_argument("folder")
    p_dw.add_argument("--calib", required=True, help="camera .npz")
    p_dw.add_argument("--file-fmt", default=".bmp")
    p_dw.add_argument("--x0", type=float, required=True,
                      help="world x of output column 0")
    p_dw.add_argument("--y0", type=float, required=True,
                      help="world y of output row 0")
    p_dw.add_argument("--pitch", type=float, required=True,
                      help="world units per output pixel")
    p_dw.add_argument("--width", type=int, required=True)
    p_dw.add_argument("--height", type=int, required=True)
    p_dw.add_argument("--z", type=float, default=0.0)
    p_dw.add_argument("--cubic", action="store_true",
                      help="cubic-spline resampling (default bilinear)")
    p_dw.add_argument("--out", default="./dewarped")
    p_dw.set_defaults(fn=cmd_dewarp)

    p_st = sub.add_parser(
        "stereo", help="two-camera 3C reconstruction from saved tables")
    p_st.add_argument("table1", help="camera-1 pair table (raw-frame run)")
    p_st.add_argument("table2", help="camera-2 pair table")
    p_st.add_argument("--calib1", required=True)
    p_st.add_argument("--calib2", required=True)
    p_st.add_argument("--z", type=float, default=0.0,
                      help="measurement-plane height")
    p_st.add_argument("--scale", type=float, default=1.0,
                      help="the scale (mm/px) the PIV runs used")
    p_st.add_argument("--dt", type=float, default=1.0,
                      help="the dt the PIV runs used")
    p_st.add_argument("--shape", type=int, nargs=2, metavar=("R", "C"),
                      default=None, help="world grid size (default: cam1's)")
    p_st.add_argument("--out", default="./Out")
    p_st.add_argument("--out-name", default="stereo_3c.txt")
    p_st.add_argument("--vtk", action="store_true",
                      help="also write a VTK file with dz/residual scalars")
    p_st.set_defaults(fn=cmd_stereo)

    return parser


def main(argv=None) -> int:
    # the build cache of every kernel and of the native decoder; enabling
    # it costs nothing for the subcommands that build nothing
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if getattr(args, "verbose", False) else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s",
    )
    import torch

    # the engine refuses TF32 on a card (a TF32 predictor upsample flips
    # CWS integer-crossing decisions); a command line owns its process
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return args.fn(args)



if __name__ == "__main__":
    sys.exit(main())
