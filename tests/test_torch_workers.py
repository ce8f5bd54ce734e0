"""Torch's intra-op threads under the parallel tier-1 run.

The suite runs six pytest-xdist workers on machines with few cores.  With
torch's default intra-op pool (one OpenMP thread a core in every worker)
the cores are oversubscribed several times over, and each parallel region
waits at its barrier for threads that are not scheduled: twelve tests of
``test_torch_resample.py`` took 227 s with 8 threads and 3.9 s with 1,
beside five busy processes on 8 cores, against 3.9 s alone.  The port's
CPU tests use small tensors and gain nothing from the pool, so the CPU
tests run torch on one intra-op thread.

Every xdist worker imports every test module when it collects, before any
test runs, so the call below applies to the whole run; run alone, a file
keeps torch's default, which is the fast case there."""
import torch

torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1
