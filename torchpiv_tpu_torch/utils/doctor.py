"""Environment self-check (``tpiv-torch doctor``): verify a host is ready
before a long acquisition run — the CUDA card, the build cache, the native
decoder, host->device bandwidth, dispatch latency and an engine smoke test
with known synthetic flow.  The port's counterpart of
``torchpiv_tpu/utils/doctor.py``: the same checks in the same order, the
same result dicts and the same report, on torch.

Where the JAX doctor proves that XLA's persistent compilation cache keys
stay stable across processes, this one proves the same of the port's
build cache (``utils.compile_cache``): a second process loads the
libraries the first one built and builds none.  On a card, a kernel that
``nvcc`` cannot build fails the checks that need it; nothing falls back to
the kernels' plain versions.
"""
from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List

ENGINE_DISPLACEMENT = (3.3, -2.1)  # px, the smoke test's synthetic flow


def _check(results: List[dict], name: str, fn: Callable[[], str]):
    """Run one named check, capturing ok/detail/exception."""
    t0 = time.perf_counter()
    try:
        detail = fn()
        results.append(dict(name=name, ok=True, detail=detail,
                            seconds=round(time.perf_counter() - t0, 2)))
    except Exception as e:  # noqa: BLE001 - each check reports, not raises
        results.append(dict(name=name, ok=False, detail=f"{e!r}",
                            seconds=round(time.perf_counter() - t0, 2)))


def _nvcc():
    """The ``nvcc`` the kernels are built with, or None."""
    from ..kernels import _build

    try:
        return _build._nvcc()
    except RuntimeError:
        return None


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "power limit not read (no nvidia-smi)"
    return f"power limit {out.splitlines()[0].strip()}"


# the cache round-trip's probe: each process loads the native decoder and,
# where there is an nvcc, one kernel, and reports what it wrote
_PROBE = r"""
import json, os, sys, time
t0 = time.perf_counter()
from torchpiv_tpu_torch.utils.compile_cache import enable_compile_cache
d = enable_compile_cache()
before = set(os.listdir(d)) if os.path.isdir(d) else set()
from torchpiv_tpu_torch.native import loader
if not loader.available():
    sys.exit("the native decoder did not build (g++)")
from torchpiv_tpu_torch.kernels import _build
try:
    _build._nvcc()
except RuntimeError:
    pass
else:
    _build.load("shift_windows")
wrote = sorted(set(os.listdir(d)) - before)
print("TPIV_PROBE:" + json.dumps({"wrote": wrote,
                                  "seconds": time.perf_counter() - t0}))
"""


def run_doctor(device: str = "auto", engine_check: bool = True,
               bandwidth_mb: int = 64,
               cache_roundtrip: bool = False) -> List[dict]:
    """Run all checks; returns a list of
    ``{name, ok, detail, seconds}`` dicts (order = execution order).

    The first device contact is time-bounded (``TPIV_DOCTOR_TIMEOUT``
    seconds, default 120), as in the JAX doctor: a CUDA runtime that does
    not answer must be reported in bounded time.  On timeout the
    device-touching checks are marked failed/skipped; host-side checks
    (build cache, native decoder) still run.  The probing thread is a
    daemon left to finish on its own."""
    import json
    import subprocess
    import sys
    import threading

    results: List[dict] = []
    backend_ok = True
    state: Dict[str, object] = {}

    def torch_devices():
        nonlocal backend_ok
        import torch

        from ..pipeline import DeviceMap

        timeout = float(os.environ.get("TPIV_DOCTOR_TIMEOUT", 120))
        box: Dict[str, object] = {}

        def dial():
            try:
                box["cuda"] = torch.cuda.is_available()
                box["dev"] = DeviceMap.resolve(device)
            except Exception as e:  # noqa: BLE001 - reported below
                box["err"] = e

        t = threading.Thread(target=dial, name="doctor-backend-dial",
                             daemon=True)
        t.start()
        t.join(timeout)
        if t.is_alive():
            backend_ok = False
            raise RuntimeError(
                f"backend not responding after {timeout:.0f}s — CUDA did "
                "not answer (the probe keeps blocking in the background)")
        if "err" in box:
            backend_ok = False
            raise box["err"]  # type: ignore[misc]
        dev = state["dev"] = box["dev"]
        if not box["cuda"]:
            return f"no CUDA device; using {dev}"
        cards = []
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            cards.append(f"cuda:{i} {p.name}, {p.total_memory / 2**30:.1f} GiB")
        return (f"{len(cards)} CUDA device(s): {'; '.join(cards)}; "
                f"{_power_limit()}; using {dev}")

    _check(results, "torch devices", torch_devices)

    def on_card() -> bool:
        dev = state.get("dev")
        return dev is not None and dev.type == "cuda"  # type: ignore[union-attr]

    def versions():
        import numpy
        import torch

        nvcc = _nvcc()
        text = (f"torch {torch.__version__}, CUDA runtime "
                f"{torch.version.cuda or 'none (CPU build)'}, "
                f"numpy {numpy.__version__}")
        if nvcc is not None:
            out = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
            release = [ln for ln in out.splitlines() if "release" in ln]
            text += f", nvcc {release[-1].strip() if release else out.strip()}"
        return text

    _check(results, "versions", versions)

    def cache():
        from .compile_cache import enable_compile_cache

        d = enable_compile_cache()
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(d, ".doctor_probe")
        with open(probe, "w") as f:
            f.write("ok")
        os.remove(probe)
        n = sum(1 for x in os.listdir(d)
                if x.startswith("lib") and x.endswith(".so"))
        text = f"{d} writable, {n} built libraries"
        if on_card():
            nvcc = _nvcc()
            if nvcc is None:
                raise RuntimeError(f"{text}; nvcc not found: the CUDA "
                                   "kernels cannot be built for the card")
            text += f"; nvcc {nvcc}"
        return text

    _check(results, "compile cache", cache)

    def native():
        import numpy as np

        from ..io.decode import imwrite_gray
        from ..native import loader as fastio

        if not fastio.available():
            raise RuntimeError("native fastio unavailable (C++ toolchain "
                               "missing?) — python decoder fallback active")
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "probe.bmp")
            img = np.arange(64 * 64, dtype=np.uint8).reshape(64, 64)
            imwrite_gray(p, img)
            dims = fastio.probe_gray(p)
            if dims is None:
                raise RuntimeError(f"native probe failed for {p} (library "
                                   "loaded but the BMP header was rejected)")
            frames, status = fastio.read_batch_gray([p], dims, threads=1)
            if status[0] != 0 or not (frames[0] == img).all():
                raise RuntimeError("native decode round-trip mismatch")
        return "C++ decoder round-trip ok"

    _check(results, "native decoder", native)

    def skipped():
        raise RuntimeError("skipped: backend unreachable (see 'torch devices')")

    def sync(dev):
        import torch

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def bandwidth():
        import torch

        dev = state["dev"]
        blob = torch.zeros((bandwidth_mb, 1024, 1024), dtype=torch.uint8)
        if dev.type == "cuda":  # the pipeline stages frames in pinned memory
            blob = blob.pin_memory()
        blob[:1].to(dev, copy=True)  # the context and the allocator first
        sync(dev)
        t = time.perf_counter()
        blob.to(dev, copy=True)
        sync(dev)
        dt = time.perf_counter() - t
        mbps = blob.numel() / 2**20 / dt
        frame_mb = 4.0  # 4 MP uint8
        note = ""
        if mbps < 100:
            note = (" — SLOW for sustained 4 MP ingest "
                    f"(~{mbps / (2 * frame_mb):.1f} pairs/s H2D bound); "
                    "fine if frames are staged once")
        return (f"host->{dev} {mbps:.0f} MB/s ({bandwidth_mb} MB "
                f"{'pinned ' if dev.type == 'cuda' else ''}probe){note}")

    _check(results, "h2d bandwidth", bandwidth if backend_ok else skipped)

    def dispatch():
        import torch

        dev = state["dev"]
        x = torch.zeros(1, device=dev)
        (x + 1).cpu()  # the first launch and readback
        t = time.perf_counter()
        reps = 10
        for _ in range(reps):
            # pull every result back to the host: the readback is the
            # per-call overhead a result consumer pays
            x = (x + 1).cpu().to(dev)
        ms = (time.perf_counter() - t) / reps * 1000
        return f"{ms:.3f} ms/dispatch+readback round trip on {dev}"

    _check(results, "dispatch latency", dispatch if backend_ok else skipped)

    if cache_roundtrip:
        def cache_hits():
            # Load the same libraries in TWO fresh subprocesses pointed at a
            # build directory of this doctor run: the first builds them, the
            # second must load them from disk, proving that the libraries'
            # names (the hashes of what went into them) are stable across
            # processes.  Each process writes a sentinel line with the files
            # it added to the directory.
            root = str(Path(__file__).resolve().parents[2])  # the package's parent
            outs = []
            with tempfile.TemporaryDirectory(prefix="tpiv_doctor_cache_") as td:
                env = dict(os.environ, TORCHPIV_CACHE_DIR=td,
                           PYTHONPATH=os.pathsep.join(
                               [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                         if p]))
                for _ in range(2):
                    r = subprocess.run([sys.executable, "-c", _PROBE],
                                       capture_output=True, text=True, env=env)
                    if r.returncode != 0:
                        raise RuntimeError(
                            f"cache probe subprocess failed: {r.stderr[-300:]}")
                    toks = [ln for ln in r.stdout.splitlines()
                            if ln.startswith("TPIV_PROBE:")]
                    if not toks:
                        raise RuntimeError(
                            "probe subprocess emitted no TPIV_PROBE sentinel "
                            f"(stdout: {r.stdout[-200:]!r})")
                    outs.append(json.loads(toks[-1][len("TPIV_PROBE:"):]))
            (w1, s1), (w2, s2) = ((o["wrote"], o["seconds"]) for o in outs)
            libs = [n for n in w1 if n.endswith(".so")]
            if not libs:
                raise RuntimeError("first process built no library — the "
                                   "build directory is not written")
            if w2:
                raise RuntimeError(
                    f"second process built again ({w2}) — the libraries' "
                    "names are not stable across processes; every fresh "
                    "run will pay the full build")
            return (f"first: built + wrote {len(libs)} librar"
                    f"{'y' if len(libs) == 1 else 'ies'} ({', '.join(libs)}) "
                    f"in {s1:.1f} s, second: loaded from disk (wrote 0) "
                    f"in {s2:.1f} s")

        _check(results, "cache round-trip",
               cache_hits if backend_ok else skipped)

    if engine_check:
        def engine():
            import numpy as np
            import torch

            from ..config import PIVConfig
            from ..models.multipass import MultipassPIV
            from .synthetic import particle_pair

            dev = state["dev"]
            d = ENGINE_DISPLACEMENT
            fa, fb = particle_pair((256, 256), displacement=d, seed=1)
            cfg = PIVConfig(frame_shape=(256, 256), wind_size=64,
                            overlap=32, multipass=2)
            t0 = time.perf_counter()
            u, v, _ = MultipassPIV(cfg, device=dev)(
                torch.from_numpy(fa).to(dev), torch.from_numpy(fb).to(dev))
            u = u.cpu().numpy()
            v = v.cpu().numpy()
            run_s = time.perf_counter() - t0
            eu = abs(float(np.median(u)) - d[0])
            ev = abs(float(np.median(v)) - d[1])
            if eu > 0.1 or ev > 0.1:
                raise RuntimeError(
                    f"engine recovered ({np.median(u):.2f}, "
                    f"{np.median(v):.2f}), expected {d}")
            return (f"recovered ({np.median(u):.2f}, {np.median(v):.2f}) "
                    f"= truth {d} on {dev} "
                    f"(build+run {run_s:.1f} s)")

        _check(results, "engine smoke", engine if backend_ok else skipped)

    return results


def format_report(results: List[dict]) -> str:
    lines = []
    for r in results:
        mark = "ok " if r["ok"] else "FAIL"
        lines.append(f"[{mark}] {r['name']:16s} {r['detail']}")
    bad = [r for r in results if not r["ok"]]
    lines.append(
        f"{len(results) - len(bad)}/{len(results)} checks passed"
        + ("" if not bad else
           " — FAILED: " + ", ".join(r["name"] for r in bad)))
    return "\n".join(lines)
