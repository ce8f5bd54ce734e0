"""The port's campaign sharding (``torchpiv_tpu_torch.parallel.distributed``)
and its statistics state against the JAX package: ``pair_block`` and
``parse_shard``, ``EnsembleAccumulator`` (update, merge, statistics) bit for
bit, checkpoints that load across the two packages in both directions,
``merge_checkpoints`` on the same shard files with the same refusals, and
``initialize_distributed`` alone and in a two-rank gloo group of two
processes (joined within 60 s, then killed: a hung rendezvous fails the
test instead of running out the suite's clock)."""
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from torchpiv_tpu.parallel import distributed as jax_dist
from torchpiv_tpu.stats.ensemble import EnsembleAccumulator as JaxAccumulator
from torchpiv_tpu.stats.ensemble import compute_statistics as jax_statistics
from torchpiv_tpu.utils import checkpoint as jax_ckpt
from torchpiv_tpu_torch.parallel import (initialize_distributed, merge_checkpoints,
                                         pair_block, parse_shard)
from torchpiv_tpu_torch.stats import EnsembleAccumulator, compute_statistics
from torchpiv_tpu_torch.utils import checkpoint as ckpt

REPO = pathlib.Path(__file__).resolve().parents[1]
JOIN_S = 60.0


@pytest.mark.parametrize("n", [0, 1, 7, 8, 100, 4001])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_pair_block_equals_jax(n, k):
    assert [pair_block(n, i, k) for i in range(k)] == \
        [jax_dist.pair_block(n, i, k) for i in range(k)]


@pytest.mark.parametrize("i,k", [(3, 3), (-1, 2), (0, 0)])
def test_pair_block_refuses_as_jax(i, k):
    with pytest.raises(ValueError):
        jax_dist.pair_block(10, i, k)
    with pytest.raises(ValueError):
        pair_block(10, i, k)


@pytest.mark.parametrize("spec", ["0/4", "3/4", "0/1", "4/4", "-1/4", "x/4", "1",
                                  "1/0", "1/2/3", ""])
def test_parse_shard_equals_jax(spec):
    try:
        want = jax_dist.parse_shard(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_shard(spec)
        assert str(got.value) == str(e)
        return
    assert parse_shard(spec) == want


def _fields(seed, n=13, shape=(9, 11)):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape), rng.normal(size=shape)) for _ in range(n)]


def _grid(shape=(9, 11)):
    return np.meshgrid(np.arange(shape[1]) * 1.5, np.arange(shape[0]) * 1.5)


def _moments(acc):
    return [acc.n] + [getattr(acc, f) for f in ("_mu", "_mv", "_muu", "_mvv", "_muv")]


def _assert_same_state(a, b):
    ma, mb = _moments(a), _moments(b)
    assert ma[0] == mb[0]
    for x, y in zip(ma[1:], mb[1:]):
        np.testing.assert_array_equal(x, y)


def test_accumulator_equals_jax_bit_for_bit():
    fields = _fields(3)
    x, y = _grid()
    port, ref = EnsembleAccumulator(), JaxAccumulator()
    for u, v in fields:
        port.add(u, v)
        ref.add(u, v)
    _assert_same_state(port, ref)
    # the Chan merge of uneven blocks, one a singleton, and an empty one
    parts = []
    for cls in (EnsembleAccumulator, JaxAccumulator):
        merged = cls()
        for lo, hi in ((0, 4), (4, 5), (5, 5), (5, 13)):
            part = cls()
            for u, v in fields[lo:hi]:
                part.add(u, v)
            merged.merge(part)
        parts.append(merged)
    _assert_same_state(*parts)
    for got, want in ((port.finalize(x, y), ref.finalize(x, y)),
                      (parts[0].finalize(x, y), parts[1].finalize(x, y)),
                      (compute_statistics(x, y, *zip(*fields)),
                       jax_statistics(x, y, *zip(*fields)))):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        EnsembleAccumulator().finalize(x, y)


@pytest.mark.parametrize("complete", [False, True])
@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_checkpoint_round_trips_across_packages(tmp_path, direction, complete):
    fields = _fields(5, n=6)
    x, y = _grid()
    saver, loader, cls = ((ckpt, jax_ckpt, EnsembleAccumulator)
                          if direction == "port->jax"
                          else (jax_ckpt, ckpt, JaxAccumulator))
    acc = cls()
    for u, v in fields:
        acc.add(u, v)
    path = str(tmp_path / "state.npz")
    saver.save_checkpoint(path, acc, 6, x, y, complete=complete)
    got, done, gx, gy = loader.load_checkpoint(path)
    assert done == 6
    np.testing.assert_array_equal(gx, x)
    np.testing.assert_array_equal(gy, y)
    _assert_same_state(got, acc)
    assert loader.checkpoint_is_complete(path) is complete
    # an empty state too
    saver.save_checkpoint(path, cls(), 0, x, y)
    assert loader.load_checkpoint(path)[0].n == 0
    assert loader.load_checkpoint(str(tmp_path / "absent.npz")) is None


def _shards(tmp_path, blocks=((0, 5), (5, 6), (6, 13)), complete=True, save=ckpt):
    fields = _fields(9)
    x, y = _grid()
    paths = []
    for i, (lo, hi) in enumerate(blocks):
        acc = EnsembleAccumulator()
        for u, v in fields[lo:hi]:
            acc.add(u, v)
        p = str(tmp_path / f"s{i}.npz")
        save.save_checkpoint(p, acc, hi - lo, x, y, complete=complete)
        paths.append(p)
    return paths, fields, x, y


@pytest.mark.parametrize("save", [ckpt, jax_ckpt], ids=["port-files", "jax-files"])
def test_merge_checkpoints_equals_jax(tmp_path, save):
    paths, fields, x, y = _shards(tmp_path, save=save)
    acc, total, mx, my = merge_checkpoints(paths)
    jacc, jtotal, jx, jy = jax_dist.merge_checkpoints(paths)
    assert total == jtotal == len(fields)
    np.testing.assert_array_equal(mx, jx)
    np.testing.assert_array_equal(my, jy)
    _assert_same_state(acc, jacc)
    got, want = acc.finalize(mx, my), jacc.finalize(jx, jy)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _refusal(tmp_path, case):
    """Shard files for one refusal of ``merge_checkpoints``."""
    paths, _, x, y = _shards(tmp_path, complete=case != "incomplete")
    if case == "missing":
        paths.append(str(tmp_path / "absent.npz"))
    elif case == "unreadable":
        bad = tmp_path / "bad.npz"
        bad.write_bytes(b"not an npz file")
        paths.append(str(bad))
    elif case == "grid":
        other = str(tmp_path / "other.npz")
        ckpt.save_checkpoint(other, EnsembleAccumulator(), 0, x + 1.0, y, complete=True)
        paths.append(other)
    elif case == "empty":
        empty = str(tmp_path / "empty.npz")
        ckpt.save_checkpoint(empty, EnsembleAccumulator(), 0, x, y, complete=True)
        paths = [empty]
    return paths


@pytest.mark.parametrize("case,exc", [("missing", FileNotFoundError),
                                      ("unreadable", FileNotFoundError),
                                      ("incomplete", ValueError),
                                      ("grid", ValueError),
                                      ("empty", ValueError)])
def test_merge_checkpoints_refuses_as_jax(tmp_path, case, exc):
    paths = _refusal(tmp_path, case)
    with pytest.raises(exc) as want:
        jax_dist.merge_checkpoints(paths)
    with pytest.raises(exc) as got:
        merge_checkpoints(paths)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_merge_checkpoints_allow_partial_as_jax(tmp_path):
    paths = _refusal(tmp_path, "incomplete")
    acc, total, _, _ = merge_checkpoints(paths, allow_partial=True)
    jacc, jtotal, _, _ = jax_dist.merge_checkpoints(paths, allow_partial=True)
    assert total == jtotal == 13
    _assert_same_state(acc, jacc)


def test_initialize_distributed_without_environment(monkeypatch):
    for var in ("TPIV_COORDINATOR", "TPIV_NUM_PROCESSES", "TPIV_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() == (0, 1)
    # one process is a no-op too, with or without a coordinator
    assert initialize_distributed("127.0.0.1:1", 1, 0) == (0, 1)
    monkeypatch.setenv("TPIV_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TPIV_NUM_PROCESSES", "1")
    assert initialize_distributed() == (0, 1)


CHILD = """
import torch
import torch.distributed as dist
from torchpiv_tpu_torch.parallel import initialize_distributed
rank, size = initialize_distributed()
x = torch.tensor([float(rank + 1), 10.0 * (rank + 1)])
dist.all_reduce(x)
print(rank, size, dist.get_backend(), x.tolist(), flush=True)
dist.destroy_process_group()
"""


def test_two_rank_gloo_group():
    """Two processes meet on 127.0.0.1 through ``TPIV_COORDINATOR`` and
    friends; each gets ``(rank, 2)`` and the all_reduce sums both ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": "",
               "GLOO_SOCKET_IFNAME": "lo", "TPIV_COORDINATOR": f"127.0.0.1:{port}",
               "TPIV_NUM_PROCESSES": "2", "TPIV_PROCESS_ID": str(rank)}
        procs.append(subprocess.Popen([sys.executable, "-c", CHILD], env=env,
                                      cwd=str(REPO), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + JOIN_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo group did not finish within {JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == f"{rank} 2 gloo [3.0, 30.0]", out
