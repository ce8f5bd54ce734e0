"""The port's command line ``tpiv-torch`` (``torchpiv_tpu_torch.cli``) on
the CPU, against the JAX package's ``tpiv``.

* Parser parity: every subcommand of ``torchpiv_tpu.cli.build_parser()``
  with the same option strings, defaults, choices, nargs and required
  flags; the only difference is the added ``--device`` (default
  ``"auto"``) of ``warmup``, ``qc``, ``dense``, ``multidt`` and ``ptv``.
  ``--help`` of every subcommand exits 0.
* The port's own cases, as ``tests/test_cli_viz.py`` has them for ``tpiv``:
  ``run`` (empty folder, no card without ``--device cpu``, the settings
  snapshot, ``--checkpoint``, ``--smooth``, ``--mask``, ``--preprocess``,
  the global filters), ``warmup`` and ``doctor``.
* ``run``'s tables against the JAX ``PIVRunner`` running its interpreted
  Pallas kernels (``engine_options={"use_pallas": "on", "pallas_interpret":
  True}``; the JAX CLI's ``--device cpu`` pins the XLA shift): ``x``, ``y``
  equal, the velocity columns within RMS 0.01 px and fewer than 2% of the
  entries more than 0.01 px apart (``test_torch_runner.py``).
* ``ensemble``, ``qc``, ``dense``, ``multidt`` and ``ptv`` against the JAX
  CLI on the same folder, at the tolerances of ``test_torch_models.py``,
  ``test_torch_quality.py`` and ``test_torch_particles.py``: the ensemble
  field 1e-4 px; the printed quality numbers 1e-4 relative plus one unit
  of their last printed digit, counts equal; the dense fields RMS 1e-3 px;
  the multi-dt fields the parity budget with ``dt`` equal on >= 98% of the
  windows; the PTV tables >= 99% of the tracks common, their velocities
  1e-4 px, the detection counts equal.
* The host-only subcommands: both CLIs on the same inputs, every output
  file compared (arrays equal to 1e-12 relative, text equal, PNG images by
  shape and non-blank content), and their standard output equal.
"""
import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torchpiv_tpu.cli import build_parser as jax_build_parser
from torchpiv_tpu.cli import main as jax_main
from torchpiv_tpu.pipeline import PIVRunner as JaxPIVRunner
from torchpiv_tpu.utils.config import PIVParams as JaxPIVParams
from torchpiv_tpu_torch.cli import build_parser
from torchpiv_tpu_torch.cli import main as cli_main
from torchpiv_tpu_torch.io.decode import imread_gray, imwrite_gray
from torchpiv_tpu_torch.utils.persistence import load_table, save_binary, save_table
from torchpiv_tpu_torch.utils.synthetic import particle_pair, render_particles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (128, 128)
ADDED_DEVICE = {"warmup", "qc", "dense", "multidt", "ptv"}
UNIT = 1000.0  # px -> output units at scale 1, dt 1


def _subparsers(parser):
    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return action.choices


JAX_SUBCOMMANDS = sorted(_subparsers(jax_build_parser()))


def _options(sub):
    return {tuple(a.option_strings) or (a.dest,):
            (a.dest, a.default, a.choices, a.nargs, a.required, a.const,
             type(a).__name__, getattr(a.type, "__name__", a.type))
            for a in sub._actions if not isinstance(a, argparse._HelpAction)}


def test_the_same_29_subcommands():
    assert sorted(_subparsers(build_parser())) == JAX_SUBCOMMANDS
    assert len(JAX_SUBCOMMANDS) == 29
    assert build_parser().prog == "tpiv-torch"


@pytest.mark.parametrize("name", JAX_SUBCOMMANDS)
def test_parser_parity(name):
    got = _options(_subparsers(build_parser())[name])
    want = _options(_subparsers(jax_build_parser())[name])
    if name in ADDED_DEVICE:
        assert got.pop(("--device",))[:2] == ("device", "auto")
    assert got == want


@pytest.mark.parametrize("name", JAX_SUBCOMMANDS)
def test_help_of_every_subcommand(name, capsys):
    with pytest.raises(SystemExit) as e:
        cli_main([name, "--help"])
    assert e.value.code == 0
    assert capsys.readouterr().out


def test_console_script_and_module_entry():
    text = open(os.path.join(ROOT, "pyproject.toml")).read()
    assert 'tpiv = "torchpiv_tpu.cli:main"' in text
    assert 'tpiv-torch = "torchpiv_tpu_torch.cli:main"' in text
    r = subprocess.run([sys.executable, "-m", "torchpiv_tpu_torch.cli", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.startswith("usage: tpiv-torch")


# ---- the device-path subcommands on the CPU --------------------------------

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """4 pairs of 128x128 frames, displacements (1.5 + 0.5 i, -1) px."""
    d = tmp_path_factory.mktemp("clipairs")
    for i in range(4):
        fa, fb = particle_pair(SHAPE, (1.5 + 0.5 * i, -1.0), seed=10 + i)
        imwrite_gray(str(d / f"img{i:04d}_a.bmp"), fa)
        imwrite_gray(str(d / f"img{i:04d}_b.bmp"), fb)
    return str(d)


@pytest.fixture(autouse=True)
def _config_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHPIV_TPU_CONFIG_DIR", str(tmp_path / "cfg"))


RUN = ["--device", "cpu", "--wind-size", "32", "--overlap", "16"]


def test_run_empty_folder(tmp_path):
    (tmp_path / "empty").mkdir()
    assert cli_main(["run", str(tmp_path / "empty"), "--device", "cpu"]) == 1


def test_run_without_a_card_names_device_cpu(folder, monkeypatch, capsys):
    """No card and no ``--device``: an error naming ``--device cpu``, never
    a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["run", folder], ["qc", folder], ["warmup", "128x128"],
                ["dense", folder], ["ensemble", folder]):
        with pytest.raises(SystemExit) as e:
            cli_main(cmd)
        assert "--device cpu" in str(e.value.code), cmd
    with pytest.raises(SystemExit, match="unknown device 'tpu'"):
        cli_main(["run", folder, "--device", "tpu"])


def test_run_snapshots_settings(folder, tmp_path):
    rc = cli_main(["run", folder, *RUN, "--save", "Save statistics",
                   "--save-dir", str(tmp_path / "out")])
    assert rc == 0
    assert any(f.endswith("_statistics.txt") for f in os.listdir(tmp_path / "out"))
    cfg = json.loads((tmp_path / "cfg" / "settings.json").read_text())
    assert cfg["wind_size"] == 32 and cfg["device"] == "cpu"


def test_settings_prints_the_snapshot(folder, tmp_path, capsys):
    JaxPIVParams(wind_size=48).to_json(str(tmp_path / "s.json"))
    assert cli_main(["settings", "--path", str(tmp_path / "s.json")]) == 0
    assert json.loads(capsys.readouterr().out)["wind_size"] == 48


def test_run_checkpoint_removed_at_the_end(folder, tmp_path):
    ck = tmp_path / "run.ckpt.npz"
    rc = cli_main(["run", folder, *RUN, "--save", "Dont save",
                   "--checkpoint", str(ck), "--checkpoint-every", "1"])
    assert rc == 0 and not ck.exists()


def test_run_smooth(folder, tmp_path):
    rc = cli_main(["run", folder, *RUN, "--save", "Save statistics",
                   "--save-dir", str(tmp_path / "o"), "--smooth"])
    assert rc == 0
    with pytest.raises(SystemExit):
        cli_main(["run", folder, *RUN, "--smooth", "-1"])


def test_run_mask_zeroes_the_masked_band(folder, tmp_path):
    mask = np.zeros(SHAPE, np.uint8)
    mask[:32, :] = 255
    imwrite_gray(str(tmp_path / "mask.bmp"), mask)
    rc = cli_main(["run", folder, *RUN, "--save", "Save all text",
                   "--save-dir", str(tmp_path / "o"), "--mask",
                   str(tmp_path / "mask.bmp")])
    assert rc == 0
    first = load_table(sorted(glob.glob(str(tmp_path / "o" / "*_pair.txt")))[0])
    assert (first["Vx[m/s]"][-2:] == 0).all()  # the rows flip to y-up


@pytest.mark.parametrize("extra", [
    ["--preprocess", "clahe"], ["--preprocess", "stretch"],
    ["--u-limits=-8,8", "--v-limits=-8,8", "--global-std", "4",
     "--median-filter", "normmedian", "--second-peak-fallback"],
])
def test_run_preprocess_and_global_filters(folder, tmp_path, extra):
    rc = cli_main(["run", folder, *RUN, "--save", "Save statistics",
                   "--save-dir", str(tmp_path / "o"), *extra])
    assert rc == 0
    (stats,) = glob.glob(str(tmp_path / "o" / "*_statistics.txt"))
    assert np.isfinite(load_table(stats)["Vx[m/s]"]).all()


def test_run_bad_limits_and_rpc_diameter(folder):
    with pytest.raises(SystemExit):
        cli_main(["run", folder, *RUN, "--u-limits", "abc"])
    with pytest.raises(SystemExit, match="rpc"):
        cli_main(["run", folder, *RUN, "--rpc-diameter", "3.0"])


@pytest.fixture(scope="module")
def jax_runner_dir(folder, tmp_path_factory):
    """The JAX ``PIVRunner`` (interpreted Pallas kernels) with per-pair text
    saves, as ``tpiv-torch run --save 'Save all text'`` runs it."""
    out = tmp_path_factory.mktemp("jaxrun")
    params = JaxPIVParams(wind_size=32, overlap=16, multipass=2, scale=1.0,
                          dt=1.0, device="cpu", folder=folder, save_opt="Save all text",
                          save_dir=str(out))
    assert JaxPIVRunner(params, batch_size=4, engine_options={
        "use_pallas": "on", "pallas_interpret": True}).run() is not None
    return out


def _close_px(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want)) / UNIT
    assert np.isfinite(d).all()
    assert np.sqrt(np.mean(d ** 2)) < 0.01
    assert (d > 0.01).mean() < 0.02


def test_run_matches_the_jax_runner(folder, tmp_path, jax_runner_dir):
    out = tmp_path / "out"
    rc = cli_main(["run", folder, *RUN, "--multipass", "2",
                   "--save", "Save all text", "--save-dir", str(out)])
    assert rc == 0
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jax_runner_dir)) and len(names) == 5
    for name in names:
        got = load_table(str(out / name))
        want = load_table(str(jax_runner_dir / name))
        assert list(got) == list(want)
        for key in ("x[mm]", "y[mm]"):
            np.testing.assert_array_equal(got[key], want[key])
        for key in ("Vx[m/s]", "Vy[m/s]"):
            _close_px(got[key], want[key])


def test_warmup_on_the_cpu(capsys):
    assert cli_main(["warmup", "128x128", "--wind-size", "32", "--overlap", "16",
                     "--batch-size", "2", "--multipass", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "native decoder built + cached" in out and "batch sizes [2]" in out
    assert cli_main(["warmup", "not-a-shape", "--device", "cpu"]) == 1


def test_warmup_fills_the_build_cache(tmp_path):
    """A fresh ``tpiv-torch warmup`` process leaves its libraries in
    ``TORCHPIV_CACHE_DIR`` (the native decoder's on the CPU)."""
    cache = tmp_path / "cache"
    env = dict(os.environ, TORCHPIV_CACHE_DIR=str(cache), PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "torchpiv_tpu_torch.cli", "warmup",
                        "128x128", "--wind-size", "32", "--overlap", "16",
                        "--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert str(cache) in r.stdout
    assert [p.name for p in cache.glob("lib*.so")], "no library in the cache"


DOCTOR_CHECKS = ("torch devices", "versions", "compile cache", "native decoder",
                 "h2d bandwidth", "dispatch latency", "engine smoke")


def test_doctor_passes_every_check_on_the_cpu(capsys):
    rc = cli_main(["doctor", "--device", "cpu", "--bandwidth-mb", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for name in DOCTOR_CHECKS:
        assert name in out, out
    assert "7/7 checks passed" in out
    assert "= truth (3.3, -2.1)" in out


def test_doctor_no_engine_and_a_failing_decoder(capsys, monkeypatch):
    rc = cli_main(["doctor", "--device", "cpu", "--no-engine", "--bandwidth-mb", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "engine smoke" not in out and "6/6 checks passed" in out
    from torchpiv_tpu_torch.native import loader

    monkeypatch.setattr(loader, "available", lambda: False)
    rc = cli_main(["doctor", "--device", "cpu", "--no-engine", "--bandwidth-mb", "1"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "FAILED: native decoder" in out


def test_doctor_cache_round_trip(capsys):
    """Two fresh processes on a fresh build directory: the first builds,
    the second loads what it built and builds nothing."""
    rc = cli_main(["doctor", "--device", "cpu", "--no-engine", "--bandwidth-mb", "1",
                   "--cache"])
    out = capsys.readouterr().out
    assert rc == 0, out
    line = [ln for ln in out.splitlines() if "cache round-trip" in ln][0]
    assert re.search(r"first: built \+ wrote \d+ librar(y|ies) \(libfastio-", line), line
    assert "second: loaded from disk (wrote 0)" in line


def test_doctor_bounded_when_cuda_hangs(capsys, monkeypatch):
    monkeypatch.setenv("TPIV_DOCTOR_TIMEOUT", "0.2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: time.sleep(5))
    t0 = time.perf_counter()
    rc = cli_main(["doctor", "--device", "cpu", "--bandwidth-mb", "1"])
    out = capsys.readouterr().out
    assert time.perf_counter() - t0 < 4.0, "doctor must not wait out the dial"
    assert rc == 1
    assert "backend not responding after 0s" in out
    assert "skipped: backend unreachable" in out
    # the host-side checks still ran and passed
    for name in ("versions", "compile cache", "native decoder"):
        assert f"[ok ] {name}" in out, out
    assert "FAILED: torch devices, h2d bandwidth, dispatch latency, engine smoke" in out


# ---- the device-path subcommands against the JAX CLI ------------------------

def _both(tmp_path, argv, jax_argv=None, capsys=None):
    """Run ``tpiv`` then ``tpiv-torch`` with outputs under ``tmp_path /
    "jax"`` and ``"port"``; returns the two directories (and the two
    standard outputs when ``capsys`` is given)."""
    dirs, outs = [], []
    for main, name, args in ((jax_main, "jax", jax_argv or argv),
                             (cli_main, "port", argv)):
        out = tmp_path / name
        assert main([a.replace("{out}", str(out)) for a in args]) == 0, name
        dirs.append(out)
        if capsys is not None:
            outs.append(capsys.readouterr().out)
    return (*dirs, *outs)


NUM = re.compile(r"-?\d+(?:\.(\d+))?")


def _same_numbers(got: str, want: str, rel: float) -> None:
    """The same lines with every number within ``rel`` relative plus one
    unit of its last printed digit; integers equal."""
    gl, wl = got.strip().splitlines(), want.strip().splitlines()
    assert len(gl) == len(wl), (got, want)
    for g, w in zip(gl, wl):
        assert NUM.sub("#", g) == NUM.sub("#", w), (g, w)
        for mg, mw in zip(NUM.finditer(g), NUM.finditer(w)):
            step = 10.0 ** -len(mw.group(1)) if mw.group(1) else 0.0
            a, b = float(mg.group()), float(mw.group())
            assert abs(a - b) <= rel * abs(b) + step * 1.0001, (g, w)


def test_ensemble_matches_the_jax_cli(folder, tmp_path):
    jax_dir, port_dir = _both(tmp_path, ["ensemble", folder, "--device", "cpu",
                                         "--batch-size", "3", "--out", "{out}"])
    got = load_table(str(port_dir / "ensemble_field.txt"))
    want = load_table(str(jax_dir / "ensemble_field.txt"))
    for key in ("x[mm]", "y[mm]"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("Vx[m/s]", "Vy[m/s]"):
        assert np.abs(got[key] - want[key]).max() / UNIT <= 1e-4


def test_ensemble_background_matches_the_jax_cli(folder, tmp_path):
    """The saturating uint8 background subtract on the device."""
    jax_dir, port_dir = _both(tmp_path, ["ensemble", folder, "--device", "cpu",
                                         "--background", "auto", "--out", "{out}"])
    got = load_table(str(port_dir / "ensemble_field.txt"))
    want = load_table(str(jax_dir / "ensemble_field.txt"))
    for key in ("Vx[m/s]", "Vy[m/s]"):
        assert np.abs(got[key] - want[key]).max() / UNIT <= 1e-4


def test_qc_prints_the_jax_numbers(folder, tmp_path, capsys):
    common = [folder, "--wind-size", "32", "--overlap", "16", "--pairs", "2"]
    assert jax_main(["qc", *common]) == 0
    want = capsys.readouterr().out
    assert cli_main(["qc", *common, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "SNR median" in got and "seeding:" in got
    _same_numbers(got, want, rel=1e-4)


@pytest.mark.parametrize("hybrid", [False, True], ids=["dense", "hybrid"])
def test_dense_matches_the_jax_cli(folder, tmp_path, hybrid):
    argv = ["dense", folder, "--pairs", "2", "--out", "{out}"]
    if hybrid:
        argv.append("--hybrid")
    jax_dir, port_dir = _both(tmp_path, argv + ["--device", "cpu"], argv)
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) == ["dense_0000.txt", "dense_0001.txt"]
    for name in names:
        got, want = load_table(str(port_dir / name)), load_table(str(jax_dir / name))
        for key in ("x[mm]", "y[mm]"):
            np.testing.assert_array_equal(got[key], want[key])
        for key in ("Vx[m/s]", "Vy[m/s]"):
            d = (got[key] - want[key]) / UNIT
            assert np.sqrt(np.mean(d ** 2)) <= 1e-3


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """6 frames of particles moving 0.8 px/frame in x."""
    d = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(7)
    n = int(0.02 * SHAPE[0] * SHAPE[1])
    xs, ys = rng.uniform(-8, SHAPE[1] + 8, n), rng.uniform(-8, SHAPE[0] + 8, n)
    inten = rng.uniform(120, 250, n)
    for t in range(6):
        f = render_particles(SHAPE, xs + 0.8 * t, ys, inten, diameter=2.5)
        f = np.clip(f + rng.normal(8.0, 2.0, SHAPE), 0, 255).astype(np.uint8)
        imwrite_gray(str(d / f"frame{t:03d}.bmp"), f)
    return str(d)


def test_multidt_matches_the_jax_cli(sequence, tmp_path):
    argv = ["multidt", sequence, "--wind-size", "32", "--overlap", "16",
            "--multipass", "2", "--out", "{out}"]
    jax_dir, port_dir = _both(tmp_path, argv + ["--device", "cpu"], argv)
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) and len(names) == 2
    for name in names:
        got, want = np.load(port_dir / name), np.load(jax_dir / name)
        np.testing.assert_array_equal(got[:2], want[:2])
        assert np.mean(got[4] == want[4]) >= 0.98
        both = np.isfinite(got[2]) & np.isfinite(want[2])
        assert np.mean(np.isfinite(got[2]) != np.isfinite(want[2])) < 0.02
        d = np.concatenate([(got[2] - want[2])[both], (got[3] - want[3])[both]])
        assert np.sqrt(np.mean(d ** 2)) < 0.01


def test_ptv_matches_the_jax_cli(folder, tmp_path, capsys):
    argv = ["ptv", folder, "--pairs", "2", "--out", "{out}"]
    jax_dir, port_dir, want_out, got_out = _both(
        tmp_path, argv + ["--device", "cpu"], argv, capsys=capsys)
    for g, w in zip(got_out.splitlines()[:2], want_out.splitlines()[:2]):
        assert g.split(" tracked")[0].split(",")[0] == w.split(" tracked")[0].split(",")[0]
    for name in ("ptv_0000.txt", "ptv_0001.txt"):
        tables = []
        for d in (port_dir, jax_dir):  # scattered rows: x, y, u, v, residual
            t = np.loadtxt(str(d / name), delimiter=",", skiprows=1, ndmin=2)
            tables.append({(round(float(x), 3), round(float(y), 3)): (u, v)
                           for x, y, u, v in t[:, :4]})
        got, want = tables
        common = set(got) & set(want)
        assert len(common) >= 0.99 * max(len(got), len(want)) and common
        assert max(max(abs(got[k][0] - want[k][0]), abs(got[k][1] - want[k][1]))
                   for k in common) / UNIT <= 1e-4


# ---- the host-only subcommands against the JAX CLI --------------------------

def _pinhole(theta_deg, dist=0.0):
    th = np.radians(theta_deg)

    def proj(x, y, z):
        xr = np.cos(th) * x + np.sin(th) * z
        zr = -np.sin(th) * x + np.cos(th) * z
        X = 640.0 + 12.0 * xr * (1 - 1e-3 * zr) + dist * 1e-4 * (xr**2 + y**2)
        Y = 480.0 + 12.0 * y * (1 - 1e-3 * zr)
        return X, Y

    return proj


@pytest.fixture(scope="module")
def host_inputs(tmp_path_factory):
    """Saved fields, tables, calibration points and mappings, raw frames,
    shard states and a PTV table, each made from a seed."""
    from torchpiv_tpu_torch.calib import CameraMapping
    from torchpiv_tpu_torch.stats.ensemble import EnsembleAccumulator
    from torchpiv_tpu_torch.utils.checkpoint import save_checkpoint

    root = tmp_path_factory.mktemp("host")
    rng = np.random.default_rng(11)
    R, C, T = 12, 16, 10
    x, y = np.meshgrid(np.arange(C) * 2.0, np.arange(R)[::-1] * 2.0)  # mm, y-up
    fields = root / "fields"
    for t in range(T):
        ph = 2 * np.pi * 2.0 * t / 10.0 + x / 8.0
        u = 0.5 + 0.1 * np.sin(ph) + 0.02 * rng.standard_normal((R, C))
        v = -0.2 + 0.05 * np.cos(ph + y / 6.0) + 0.02 * rng.standard_normal((R, C))
        save_binary(f"pair_{t}.npy", str(fields), {"x": x, "y": y, "u": u, "v": v})
    table = {"x[mm]": x, "y[mm]": y, "Vx[m/s]": 0.5 + 0.1 * np.sin(x / 5.0),
             "Vy[m/s]": -0.2 + 0.1 * np.cos(y / 7.0)}
    save_table("field.txt", str(root), table)
    other = dict(table, **{"Vx[m/s]": table["Vx[m/s]"] + 0.001})
    other["Vx[m/s]"][0, 0] = np.nan
    save_table("other.txt", str(root), other)
    cams, points = {}, {}
    g = np.linspace(-20, 20, 9)
    wx, wy, wz = np.meshgrid(g, g, [-2.0, 0.0, 2.0], indexing="ij")
    world = np.stack([wx.ravel(), wy.ravel(), wz.ravel()], axis=1)
    for name, proj in (("cam1", _pinhole(30.0, 1.0)), ("cam2", _pinhole(-30.0, -0.5))):
        X, Y = proj(world[:, 0], world[:, 1], world[:, 2])
        pts = np.column_stack([world, X, Y])
        points[name] = str(root / f"{name}.csv")
        np.savetxt(points[name], pts, delimiter=",", header="x,y,z,X,Y", comments="")
        cams[name] = str(root / f"{name}.npz")
        CameraMapping.fit(world, np.column_stack([X, Y])).save(cams[name])
        gx, gy = np.meshgrid(np.arange(460, 830, 16.0), np.arange(300, 670, 16.0))
        save_table(f"{name}_table.txt", str(root), {
            "x[mm]": gx, "y[mm]": gy[::-1],
            "Vx[m/s]": 500.0 + 20.0 * np.sin(gy / 50.0),
            "Vy[m/s]": -100.0 + 10.0 * np.cos(gx / 40.0)})
    raw = root / "raw"
    raw.mkdir()
    for n in ("a_0", "b_0"):
        imwrite_gray(str(raw / f"{n}.bmp"), rng.integers(0, 255, (96, 128), dtype=np.uint8))
    for i in range(2):
        acc = EnsembleAccumulator()
        for _ in range(2 + i):
            acc.add(rng.standard_normal((R, C)), rng.standard_normal((R, C)))
        save_checkpoint(str(root / f"s{i}.npz"), acc, acc.n, x, y, complete=True)
    k = rng.uniform(0, 100, 40)
    save_table("ptv_0000.txt", str(root), {
        "x[mm]": k, "y[mm]": rng.uniform(0, 100, 40), "Vx[m/s]": np.sin(k),
        "Vy[m/s]": np.cos(k), "residual[px]": rng.uniform(0, 0.2, 40)})
    return {"fields": str(fields), "table": str(root / "field.txt"),
            "other": str(root / "other.txt"), "npy": str(fields / "pair_3.npy"),
            "pts1": points["cam1"], "cam1": cams["cam1"], "cam2": cams["cam2"],
            "t1": str(root / "cam1_table.txt"), "t2": str(root / "cam2_table.txt"),
            "raw": str(raw), "s0": str(root / "s0.npz"), "s1": str(root / "s1.npz"),
            "ptv": str(root / "ptv_0000.txt")}


HOST_CASES = {
    "export_vtk": ["export", "{table}", "--out", "out", "--derived"],
    "export_mat": ["export", "{npy}", "--format", "mat", "--out", "out", "--derived"],
    "export_h5": ["export", "{table}", "--format", "h5", "--out", "out"],
    "pod": ["pod", "{fields}", "--modes", "3", "--out", "out"],
    "spod": ["spod", "{fields}", "--fs", "10", "--n-fft", "4", "--out", "out"],
    "temporal": ["temporal", "{fields}", "--fs", "10", "--point", "3,4", "--point",
                 "6,8", "--phase-bins", "2", "--out", "out"],
    "report": ["report", "{fields}", "--fs", "10", "--rho", "998", "--out", "out"],
    "compare": ["compare", "{table}", "{other}", "--tol", "0.01"],
    "turbulence": ["turbulence", "{fields}", "--nu", "1.5e-5", "--out", "out"],
    "dmd": ["dmd", "{fields}", "--fs", "10", "--rank", "4", "--out", "out"],
    "pressure": ["pressure", "{fields}", "--rho", "998", "--fs", "10", "--out", "out"],
    "pressure_mean": ["pressure", "{fields}", "--mode", "mean", "--out", "out"],
    "calib": ["calib", "--points", "{pts1}", "--skiprows", "1", "--out", "out/cam.npz"],
    "dewarp": ["dewarp", "{raw}", "--calib", "{cam1}", "--x0", "-10", "--y0", "-10",
               "--pitch", "0.5", "--width", "40", "--height", "32", "--cubic",
               "--out", "out"],
    "stereo": ["stereo", "{t1}", "{t2}", "--calib1", "{cam1}", "--calib2", "{cam2}",
               "--out", "out", "--vtk"],
    "merge_stats": ["merge-stats", "{s0}", "{s1}", "--save-dir", "out", "--name", "camp"],
    "view": ["view", "{table}", "--field", "Vx[m/s]", "--vectors", "--out", "out/v.png"],
    "view_ptv": ["view", "{ptv}", "--out", "out/p.png"],
}


def _arrays(path):
    """The arrays of a binary output file, by name."""
    if path.endswith(".npy"):
        return {"": np.load(path)}
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if path.endswith(".mat"):
        from scipy.io import loadmat

        return {k: v for k, v in loadmat(path).items() if not k.startswith("__")}
    if path.endswith(".h5"):
        import h5py

        out = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda k, d: out.__setitem__(k, d[()])
                         if isinstance(d, h5py.Dataset) else None)
            out.update({f"@{k}": v for k, v in f.attrs.items()})
        return out
    if path.endswith(".bmp"):
        return {"": imread_gray(path)}
    return None


def _same_file(got_path, want_path):
    if got_path.endswith(".png"):
        import matplotlib.image as mpimg

        got, want = mpimg.imread(got_path), mpimg.imread(want_path)
        assert got.shape == want.shape
        for img in (got, want):  # drawn on: not one colour
            assert np.ptp(img[..., :3]) > 0
        return
    want = _arrays(want_path)
    if want is None:  # text
        with open(got_path) as g, open(want_path) as w:
            assert g.read() == w.read(), got_path
        return
    got = _arrays(got_path)
    assert list(got) == list(want), got_path
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (got_path, k)
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_subcommand_outputs_equal_jax(case, host_inputs, tmp_path, monkeypatch,
                                           capsys):
    import matplotlib

    matplotlib.use("Agg")
    argv = [a.format(**host_inputs) if a.startswith("{") else a
            for a in HOST_CASES[case]]
    results = {}
    for name, main in (("jax", jax_main), ("port", cli_main)):
        cwd = tmp_path / name
        (cwd / "out").mkdir(parents=True)
        monkeypatch.chdir(cwd)
        rc = main(list(argv))
        results[name] = (rc, capsys.readouterr().out)
    assert results["port"] == results["jax"] and results["jax"][0] == 0
    files = {}
    for name in ("jax", "port"):
        base = tmp_path / name
        files[name] = sorted(str(p.relative_to(base)) for p in base.rglob("*")
                             if p.is_file())
    assert files["port"] == files["jax"], files
    assert files["jax"] or case == "compare"  # compare only prints
    for rel in files["jax"]:
        _same_file(str(tmp_path / "port" / rel), str(tmp_path / "jax" / rel))
