"""Distribution layer (T2/T7/T8): row-partitioned auction over device meshes.

The reference is single-process (SURVEY.md SS6 'Distributed communication
backend: Absent'); this subpackage is the multi-device scaling design --
a shard_map'd Jacobi round over a row-sharded ELL layout with replicated
price/assignment state and per-round pmax/pmin combines, which XLA hands
to NCCL (NVLink between the cards of one host, the network between
hosts).
"""

from sslap_tpu.parallel.mesh import make_mesh, initialize_multihost
from sslap_tpu.parallel.partition import (
    pad_rows_for_mesh,
    partition_rows,
    shard_nnz_counts,
)
from sslap_tpu.parallel.sharded import auction_solve_sharded, sharded_solve_ell
from sslap_tpu.parallel.overlap import (
    auction_solve_overlapped,
    solve_ell_overlapped,
)
from sslap_tpu.parallel.sharded_compact import (
    auction_solve_sharded_hybrid,
    sharded_ladder_tiers,
)
from sslap_tpu.parallel.scaling import measure_round_breakdown

__all__ = [
    "make_mesh",
    "initialize_multihost",
    "pad_rows_for_mesh",
    "partition_rows",
    "shard_nnz_counts",
    "auction_solve_sharded",
    "auction_solve_overlapped",
    "auction_solve_sharded_hybrid",
    "sharded_ladder_tiers",
    "sharded_solve_ell",
    "solve_ell_overlapped",
    "measure_round_breakdown",
]
