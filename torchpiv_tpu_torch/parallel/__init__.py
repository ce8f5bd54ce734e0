"""Multi-device parallelism (mesh construction + sharded multipass PIV) and
multi-process campaign sharding (zero-communication DP + exact state merge);
the counterpart of ``torchpiv_tpu.parallel``."""

from .distributed import (initialize_distributed, merge_checkpoints,
                          pair_block, parse_shard)
from .mesh import default_piv_mesh, make_mesh
from .sharded import ShardedPIV

__all__ = [
    "make_mesh", "default_piv_mesh", "ShardedPIV",
    "initialize_distributed", "pair_block", "parse_shard",
    "merge_checkpoints",
]
