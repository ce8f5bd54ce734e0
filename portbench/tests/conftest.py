"""Under pytest-xdist, each worker's torch takes its share of the cores:
with every worker on every core the small windows of these tests finish
no batch (four workers on eight cores ran the engine about a hundred
times slower than one)."""
import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
