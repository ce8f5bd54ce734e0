"""The port's ``PIVRunner`` against the JAX ``PIVRunner`` (running the
interpreted Pallas kernels) over the same BMP folder: the statistics table,
the per-pair text files read back, ``smooth=True`` and a fixed ``smooth``,
a ``shard`` with its complete state; then checkpoint and resume equal to an
uninterrupted run, the empty folder, the writer thread's errors, and
``PIVParams`` files across both packages (``"tpu"`` is refused by the
port's entry points, never remapped).

Tolerance, as in ``test_torch_pipeline.py``: ``x`` and ``y`` equal, the
velocity columns within RMS 0.01 px and fewer than 2% of the entries more
than 0.01 px apart."""
import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from torchpiv_tpu.pipeline import PIVRunner as JaxPIVRunner
from torchpiv_tpu.utils.config import PIVParams as JaxPIVParams
from torchpiv_tpu.utils.persistence import load_table as jax_load_table
from torchpiv_tpu_torch.io.decode import imwrite_gray
from torchpiv_tpu_torch.pipeline import PIVRunner, _AsyncSaver
from torchpiv_tpu_torch.utils.checkpoint import checkpoint_is_complete, load_checkpoint
from torchpiv_tpu_torch.utils.config import PIVParams
from torchpiv_tpu_torch.utils.persistence import load_table
from torchpiv_tpu_torch.utils.synthetic import particle_pair

UNIT = 0.05 / 2.0 * 1000  # px -> output units at scale 0.05, dt 2
N_PAIRS = 4
# the runs of the JAX runner the tests are held against
RUNS = {"text": dict(save_opt="Save all text"), "smooth": dict(smooth=True),
        "fixed": dict(smooth=10.0), "shard": dict(shard=(1, 2))}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("pairs")
    for i in range(N_PAIRS):
        fa, fb = particle_pair((128, 128), (1.5 + 0.5 * i, -1.0), seed=10 + i)
        imwrite_gray(str(folder / f"img{i:04d}_a.bmp"), fa)
        imwrite_gray(str(folder / f"img{i:04d}_b.bmp"), fb)
    return str(folder)


def _params(cls, folder, save_dir, save_opt="Dont save"):
    return cls(wind_size=32, overlap=16, multipass=2, multipass_mode="CWS",
               scale=0.05, dt=2.0, device="cpu", file_fmt=".bmp", folder=folder,
               folder_mode="pairs", save_opt=save_opt, save_dir=str(save_dir))


def _run(cls, params_cls, folder, out, kind, **engine):
    kw = dict(RUNS[kind])
    params = _params(params_cls, folder, out, kw.pop("save_opt", "Dont save"))
    if "shard" in kw:
        kw["checkpoint_path"] = str(out / "shard.npz")
    outputs = []
    table = cls(params, on_output=outputs.append, batch_size=2, **kw, **engine).run()
    return table, outputs


@pytest.fixture(scope="module")
def jax_runs(folder, tmp_path_factory):
    out = {}
    for kind in RUNS:
        d = tmp_path_factory.mktemp(f"jax-{kind}")
        out[kind] = (*_run(JaxPIVRunner, JaxPIVParams, folder, d, kind,
                           engine_options={"pallas_interpret": True}), d)
    return out


def _close_px(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b)) / UNIT
    assert np.isfinite(d).all()
    assert np.sqrt(np.mean(d ** 2)) < 0.01
    assert (d > 0.01).mean() < 0.02


def _close_fields(got, want, xy_atol=0.0):
    """``xy_atol``: a table read back from its "%.6f" text against the
    table in memory."""
    for key in ("x[mm]", "y[mm]"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=xy_atol)
    for key in ("Vx[m/s]", "Vy[m/s]"):
        _close_px(got[key], want[key])


@pytest.mark.parametrize("kind", list(RUNS))
def test_runner_matches_jax_runner(folder, tmp_path, jax_runs, kind):
    want_table, want_out, jax_dir = jax_runs[kind]
    progress = []
    kw = dict(RUNS[kind])
    params = _params(PIVParams, folder, tmp_path, kw.pop("save_opt", "Dont save"))
    if "shard" in kw:
        kw["checkpoint_path"] = str(tmp_path / "shard.npz")
    outputs = []
    table = PIVRunner(params, on_progress=progress.append, on_output=outputs.append,
                      batch_size=2, **kw).run()
    n = N_PAIRS // 2 if kind == "shard" else N_PAIRS
    assert len(outputs) == len(want_out) == n and progress[-1] == 100
    assert list(table) == list(want_table) and len(table) == 13
    _close_fields(table, want_table)
    for got, want in zip(outputs, want_out):
        _close_fields(got, want)
    if kind == "text":  # the per-pair files and the table, read back
        files = sorted(glob.glob(str(tmp_path / "*_pair*.txt")))
        jax_files = sorted(glob.glob(str(jax_dir / "*_pair*.txt")))
        assert [os.path.basename(f) for f in files] == \
            [os.path.basename(f) for f in jax_files] and len(files) == n
        for f, jf in zip(files, jax_files):
            _close_fields(load_table(f), jax_load_table(jf))
        (stats,) = glob.glob(str(tmp_path / "*_statistics.txt"))
        _close_fields(load_table(stats), table, xy_atol=5e-7)
    if kind == "shard":  # the final state stays, marked complete
        ckpt = tmp_path / "shard.npz"
        assert checkpoint_is_complete(str(ckpt))
        acc, done, _, _ = load_checkpoint(str(ckpt))
        assert acc.n == done == n
    if kind in ("smooth", "fixed"):  # the smoother changed the fields
        rough = jax_runs["shard"][1]  # pairs 2 and 3 of a run without it
        assert not np.array_equal(outputs[2]["Vx[m/s]"], rough[0]["Vx[m/s]"])


def test_runner_checkpoint_resume(folder, tmp_path):
    """Stop after the first pair, resume from the checkpoint: the same
    statistics as an uninterrupted run, and the checkpoint removed."""
    ckpt = str(tmp_path / "run.ckpt.npz")
    params = _params(PIVParams, folder, tmp_path)
    full = PIVRunner(params, batch_size=1).run()
    runners = []

    def stop(out):
        runners[0].stop()

    runners.append(PIVRunner(params, on_output=stop, checkpoint_path=ckpt,
                             checkpoint_every=1, batch_size=1))
    runners[0].run()
    assert os.path.exists(ckpt) and load_checkpoint(ckpt)[1] == 1
    table = PIVRunner(params, checkpoint_path=ckpt, checkpoint_every=1,
                      batch_size=1).run()
    for key in full:
        np.testing.assert_allclose(table[key], full[key], atol=1e-9)
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("cls,params_cls", [(PIVRunner, PIVParams),
                                            (JaxPIVRunner, JaxPIVParams)],
                         ids=["port", "jax"])
def test_runner_empty_folder_fails(tmp_path, cls, params_cls):
    failed = []
    params = params_cls(folder=str(tmp_path), device="cpu", file_fmt=".bmp",
                        wind_size=32, overlap=16)
    assert cls(params, on_failed=lambda: failed.append(True)).run() is None
    assert failed == [True]


def test_async_saver_surfaces_a_writer_error():
    """A failed save raises at close, or at the next submit once the
    writer has met it."""
    import time

    def boom(*a):
        raise OSError("disk full")

    saver = _AsyncSaver(maxsize=2)
    saver.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        saver.close()
    saver = _AsyncSaver(maxsize=2)
    saver.submit(boom)
    deadline = time.monotonic() + 10
    while saver._err is None and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(OSError, match="disk full"):
        saver.submit(print)
    saver.close()


def test_piv_params_files_cross_both_packages(tmp_path, monkeypatch):
    jax_params = JaxPIVParams(wind_size=48, overlap=24, scale=0.1, folder="f",
                              extras={"preprocess": "clahe"})
    path = jax_params.to_json(str(tmp_path / "jax.json"))
    got = PIVParams.from_json(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_params)
    assert got.device == "tpu"  # read as written, refused where it is used
    with pytest.raises(ValueError, match="tpu"):
        PIVRunner(dataclasses.replace(got, folder=str(tmp_path))).run()
    port = PIVParams(multipass=3, regime="online", extras={"smooth": 2.0})
    assert port.device == "auto"
    back = JaxPIVParams.from_json(port.to_json(str(tmp_path / "port.json")))
    assert dataclasses.asdict(back) == dataclasses.asdict(port)
    with open(tmp_path / "port.json") as f:
        assert len(json.load(f)) == 15  # the 14 keys and extras
    # the default location: the JAX package's variable and file name
    monkeypatch.setenv("TORCHPIV_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
    assert PIVParams().to_json() == JaxPIVParams().to_json()
