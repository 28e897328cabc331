"""Distributed operation: row-partitioned operators over a communicator.

Counterpart of rocalution_tpu/parallel (which replaces the reference's
GlobalMatrix/GlobalVector/ParallelManager/MPI stack, SURVEY.md §2.7, with
row-partitioned shards and collectives under `shard_map`). The port runs
the same per-part functions over a communicator (comm.py): all parts in
one process on one device (`make_comm`), or one part per process over
torch.distributed (multiproc.py).
"""

from .comm import ProcessComm, StackedComm, process_comm
from .ops import shard_operator, shard_spmv
from .partition import (GlobalCSR, distribute_csr, distribute_vector,
                        gather_vector, global_csr_from_blocks)
from .precond import ShardPrecond, block_jacobi_precond
from .solve import block_jacobi_diag, dist_solve, make_comm

__all__ = [
    "GlobalCSR", "distribute_csr", "distribute_vector", "gather_vector",
    "global_csr_from_blocks", "shard_spmv", "shard_operator", "dist_solve",
    "make_comm", "block_jacobi_diag", "block_jacobi_precond",
    "ShardPrecond", "DistLevels", "distributed_amg_setup",
    "dist_amg_solve_sharded", "dist_levels_from_blocks",
    "global_transpose", "global_triple_product",
    "StackedComm", "ProcessComm", "process_comm",
    "DistMG", "dist_amg_solve", "distribute_hierarchy",
]
from .amg import DistMG, dist_amg_solve, distribute_hierarchy  # noqa: E402
from .amg_setup import (DistLevels, dist_amg_solve_sharded,  # noqa: E402
                        dist_levels_from_blocks, distributed_amg_setup)
from .matops import global_transpose, global_triple_product  # noqa: E402
