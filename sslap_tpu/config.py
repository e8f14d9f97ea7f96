"""Frozen solver configuration (SURVEY.md SS6 'Config / flag system').

The reference's config surface is function kwargs only; the public API
mirrors that, and ``AuctionConfig`` bundles the same knobs for reuse
across many solves (tracking workloads that re-solve similar instances):

    cfg = AuctionConfig(problem="max", theta=10.0, mode="cpu")
    res = auction_solve(mat, config=cfg)
    solver = AuctionSolver(loc=loc, val=val, shape=(n, m), config=cfg)

Explicit kwargs always override the config's values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AuctionConfig:
    """Bundle of auction_solve/AuctionSolver keyword defaults.

    Determinism contract carried by every path (SURVEY.md SS8.2 item 2):
    a row picks the highest value then the lowest column index; a column
    picks the highest bid then the lowest row id.
    """

    problem: str = "min"                 # 'min' | 'max'
    eps_start: Optional[float] = None    # default: ~(cost range)/2 (scaled)
    eps_min: Optional[float] = None      # default: 1 (int) | 1/(m+1) (float)
    theta: Optional[float] = None        # geometric eps divisor; None =
                                         # per-mode default (device 10 /
                                         # cpu 5, measured)
    theta_tail: Optional[float] = None   # mixed tail schedule: final-phase
                                         # drop ratio; None = per-mode
                                         # default, 0 = pure theta
    tail_phases: int = 2                 # phases descending by theta_tail
    max_iter: Optional[int] = None       # round cap (safety valve)
    cardinality_check: bool = True       # Hopcroft-Karp pre-check
    mode: str = "auto"                   # 'auto'|'device'|'hybrid'|'cpu'
                                         # |'sharded'|'overlapped'
    keep_assignment: bool = True         # warm-started eps phases
    dtype: Optional[object] = None       # force device dtype
    wide_rounds: Optional[bool] = None   # window-gather phase starts on
                                         # the square hybrid (None = auto,
                                         # which is off; see
                                         # ops/widebid.py)
    fine_ladder: Optional[bool] = None   # fine {2^k, 3*2^(k-1)} tier
                                         # interleave below 32768 on the
                                         # square hybrid (None = env
                                         # SSLAP_TPU_FINE_LADDER, default
                                         # ON, chosen on the earlier
                                         # accelerator and unmeasured on
                                         # the H100; see
                                         # compact.default_tiers)
    engine: str = "auto"                 # square device engine: 'auto'|
                                         # 'compact'|'candidates'|'dense'
    gs_engine: str = "auto"              # host finisher: 'auto' (= 'fr'
                                         # on the square hybrid tail,
                                         # else 'forward'), 'forward', or
                                         # 'fr' (combined forward-reverse
                                         # auction; square+native only)

    def __post_init__(self):
        if self.problem not in ("min", "max"):
            raise ValueError(
                f"problem must be 'min' or 'max', got {self.problem!r}")
        if self.theta is not None and self.theta <= 1:
            raise ValueError("theta must be > 1")
        if self.theta_tail is not None and \
                not (self.theta_tail == 0 or self.theta_tail > 1):
            raise ValueError("theta_tail must be 0 (off) or > 1")
        if self.tail_phases < 1:
            raise ValueError("tail_phases must be >= 1")
        if self.mode not in ("auto", "device", "hybrid", "cpu",
                             "sharded", "overlapped", "sharded_hybrid"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.engine not in ("auto", "compact", "candidates", "dense"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.gs_engine not in ("auto", "forward", "fr"):
            raise ValueError(f"unknown gs_engine {self.gs_engine!r}")

    def solver_kwargs(self) -> dict:
        """The kwargs this config supplies to AuctionSolver."""
        return {
            "problem": self.problem,
            "eps_start": self.eps_start,
            "eps_min": self.eps_min,
            "theta": self.theta,
            "theta_tail": self.theta_tail,
            "tail_phases": self.tail_phases,
            "max_iter": self.max_iter,
            "cardinality_check": self.cardinality_check,
            "mode": self.mode,
            "keep_assignment": self.keep_assignment,
            "dtype": self.dtype,
            "wide_rounds": self.wide_rounds,
            "fine_ladder": self.fine_ladder,
            "engine": self.engine,
            "gs_engine": self.gs_engine,
        }
