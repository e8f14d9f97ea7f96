"""sslap_tpu: sparse linear assignment on JAX (auction algorithm).

A from-scratch JAX/XLA framework, run on NVIDIA GPUs, with the
capabilities of the reference `OllieBoyne/sslap` (behavioral contract:
SURVEY.md; see SURVEY.md SS0 on the reference source): min/max-cost LAP over
dense or COO/CSR sparse cost matrices via Bertsekas' auction algorithm with
epsilon-scaling, Hopcroft-Karp feasibility checking, batched independent
instances, and row-sharded multi-device execution.
"""

from sslap_tpu.api import (
    AuctionSolution,
    AuctionSolver,
    InfeasibleError,
    auction_solve,
    hopcroft_solve,
    linear_sum_assignment,
)
from sslap_tpu.config import AuctionConfig
from sslap_tpu.ingest import ELLProblem, from_coo, from_csr, from_dense, to_dense

__version__ = "0.1.0"

__all__ = [
    "AuctionConfig",
    "AuctionSolution",
    "AuctionSolver",
    "ELLProblem",
    "InfeasibleError",
    "auction_solve",
    "hopcroft_solve",
    "linear_sum_assignment",
    "from_coo",
    "from_csr",
    "from_dense",
    "to_dense",
    "__version__",
]
