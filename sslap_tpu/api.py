"""Public API: auction_solve / hopcroft_solve / AuctionSolver (T10).

Mirrors the reference's user surface (SURVEY.md SS1, SS3a R1, SS4) with the
reconstructed contract documented in SURVEY.md SS0 (reference mount empty):

  auction_solve(mat=...)            dense, negative entries = forbidden
  auction_solve(loc=..., val=...)   COO sparse
  hopcroft_solve(...)               standalone maximum bipartite matching
  AuctionSolver(...)                construct once, solve(), inspect prices

Returns a dict-like ``AuctionSolution`` with 'sol' (row -> col int array) and
'meta' (objective, rounds, phases, final eps, solution-found flag, timing).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from sslap_tpu import auction as _auction
from sslap_tpu import feasibility as _feas
from sslap_tpu import ingest as _ingest
from sslap_tpu.ingest import ELLProblem


# Auto-mode crossover: square instances with at least this many rows go to
# the hybrid device path, smaller ones to the native CPU engine.  Chosen on
# the earlier accelerator; not yet measured on the H100.
DEFAULT_CROSSOVER = 500_000


class InfeasibleError(ValueError):
    """No perfect matching exists for the given sparsity pattern."""


_UNSET = object()  # distinguishes "kwarg not given" from an explicit value
                   # when merging with an AuctionConfig


class AuctionSolution(dict):
    """Dict with attribute access: keys 'sol', 'meta', 'prices' (and
    convenience properties).  Key names follow SURVEY.md SS1 item 7
    ([K-med]; exact reference keys unverifiable -- mount empty).
    'prices' is the final dual vector in the solver's TRANSFORMED space --
    feed it back as ``warm_prices=`` for warm-started re-solves (same
    convention on every mode).

    Warm-start guidance for drifting (tracking) workloads, measured at
    1M x 1M (PERF.md round 4): restart at a drift-matched eps
    (``eps_start ~ 4x`` the per-frame cost drift), and warm-start each
    frame from the last COLD solve's duals rather than chaining
    warm-on-warm -- forward-auction prices only ever rise, so a warm
    chain accumulates ~drift of unremovable relative price error per
    frame and the tail re-auction eventually costs more than a cold
    solve."""

    @property
    def sol(self) -> np.ndarray:
        return self["sol"]

    @property
    def meta(self) -> dict:
        return self["meta"]

    @property
    def objective(self):
        return self["meta"]["obj"]


def _ingest_any(mat=None, loc=None, val=None, shape=None, dtype=None,
                pad_to=None) -> ELLProblem:
    if isinstance(mat, ELLProblem):
        # Already-ingested problem passes through unchanged (AuctionSolver
        # hands its problem_spec to the parallel entry points this way --
        # no COO round-trip, no second O(nnz) ELL build at capacity scale).
        if loc is not None or val is not None:
            raise ValueError("pass either mat= or (loc=, val=), not both")
        return mat
    if mat is not None:
        if loc is not None or val is not None:
            raise ValueError("pass either mat= or (loc=, val=), not both")
        return _ingest.from_dense(mat, dtype=dtype, pad_to=pad_to)
    if loc is None or val is None:
        raise ValueError("pass a dense mat= or sparse loc= and val=")
    return _ingest.from_coo(loc, val, shape=shape, dtype=dtype, pad_to=pad_to)


def _objective_host(prob: ELLProblem, sol: np.ndarray) -> float:
    """Objective from original costs, computed on host in float64/int64 --
    exact regardless of the on-device dtype."""
    cols = np.asarray(prob.cols)
    vals = np.asarray(prob.vals)
    valid = np.asarray(prob.valid)
    assigned = sol >= 0
    if not assigned.any():
        return 0.0
    rows = np.nonzero(assigned)[0]
    hit = (cols[rows] == sol[rows, None]) & valid[rows]
    # every assigned (row, col) must be a stored valid entry
    slot = hit.argmax(axis=1)
    integral = np.issubdtype(vals.dtype, np.integer) or prob.int_exact
    acc_dtype = np.int64 if np.issubdtype(vals.dtype, np.integer) \
        else np.float64
    obj = vals[rows, slot].astype(acc_dtype).sum()
    return int(round(float(obj))) if integral else float(obj)


class AuctionSolver:
    """Construct-once solver over an ingested problem (reference
    ``AuctionSolver``, SURVEY.md SS4.4).  Holds prices after a solve so they
    can be inspected or reused to warm-start a similar instance."""

    def __init__(
        self,
        mat=None,
        *,
        loc=None,
        val=None,
        shape: Optional[Tuple[int, int]] = None,
        problem=_UNSET,
        eps_start=_UNSET,
        eps_min=_UNSET,
        theta=_UNSET,
        theta_tail=_UNSET,
        tail_phases=_UNSET,
        max_iter=_UNSET,
        cardinality_check=_UNSET,
        dtype=_UNSET,
        pad_to: Optional[int] = None,
        mode=_UNSET,
        keep_assignment=_UNSET,
        engine=_UNSET,
        wide_rounds=_UNSET,
        fine_ladder=_UNSET,
        gs_engine=_UNSET,
        config=None,
    ):
        # Resolution order: explicit kwarg > AuctionConfig > built-in
        # default (the reference's kwargs-first surface, SURVEY.md SS6).
        from sslap_tpu.config import AuctionConfig
        base = (config or AuctionConfig()).solver_kwargs()

        def pick(v, key):
            return base[key] if v is _UNSET else v

        problem = pick(problem, "problem")
        eps_start = pick(eps_start, "eps_start")
        eps_min = pick(eps_min, "eps_min")
        theta = pick(theta, "theta")
        theta_tail = pick(theta_tail, "theta_tail")
        tail_phases = pick(tail_phases, "tail_phases")
        max_iter = pick(max_iter, "max_iter")
        cardinality_check = pick(cardinality_check, "cardinality_check")
        mode = pick(mode, "mode")
        keep_assignment = pick(keep_assignment, "keep_assignment")
        dtype = pick(dtype, "dtype")
        engine = pick(engine, "engine")
        wide_rounds = pick(wide_rounds, "wide_rounds")
        fine_ladder = pick(fine_ladder, "fine_ladder")
        gs_engine = pick(gs_engine, "gs_engine")
        if gs_engine not in ("auto", "forward", "fr"):
            raise ValueError(f"unknown gs_engine {gs_engine!r}")

        self.problem_spec = _ingest_any(mat=mat, loc=loc, val=val, shape=shape,
                                        dtype=dtype, pad_to=pad_to)
        if self.problem_spec.n == 0:
            raise ValueError("empty problem (no rows)")
        self.problem = problem
        self.eps_start = eps_start
        self.eps_min = eps_min
        self.theta = theta
        # Mixed tail schedule (auction._next_eps): None = per-mode default,
        # 0 = pure theta descent, >1 = final-phase drop ratio.  Same
        # validation as AuctionConfig.__post_init__ (ADVICE r3: kwargs
        # passed directly must not bypass the config path's checks).
        if theta_tail is not None and not (theta_tail == 0 or theta_tail > 1):
            raise ValueError("theta_tail must be 0 (off) or > 1")
        self.theta_tail = theta_tail
        # How many final phases descend by theta_tail (static; sets the
        # clamp threshold eps_min * theta_tail**tail_phases).
        if int(tail_phases) < 1:
            raise ValueError("tail_phases must be >= 1")
        self.tail_phases = int(tail_phases)
        self.max_iter = max_iter
        self.cardinality_check = cardinality_check
        if mode not in ("auto", "device", "hybrid", "cpu", "sharded",
                        "overlapped", "sharded_hybrid"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.keep_assignment = keep_assignment
        if engine not in ("auto", "compact", "candidates", "dense"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        # Window-gather phase starts (ops/widebid.py): None = auto (off),
        # True/False = force.
        self.wide_rounds = wide_rounds
        # Fine tier interleave below 32768 (compact.default_tiers):
        # None = SSLAP_TPU_FINE_LADDER env default (on).
        self.fine_ladder = fine_ladder
        # Host finisher: 'auto' (default: FR on the square hybrid tail,
        # forward everywhere else -- see hybrid.solve_hybrid), 'forward'
        # (sslap-class GS), or 'fr' (square+native only; silently
        # forward otherwise).
        self.gs_engine = gs_engine
        self.prices: Optional[np.ndarray] = None
        self.meta: Optional[dict] = None
        # Device-resident problem data reused across solve() calls
        # (construct-once workloads re-solve with warm prices without
        # re-paying the H2D transfer; see hybrid.solve_hybrid).
        self._device_cache: dict = {}

    # -- internals ---------------------------------------------------------

    def _prepare(self, warm_prices=None):
        prob = self.problem_spec
        vals = np.asarray(prob.vals)
        valid = np.asarray(prob.valid)
        vmax_abs = float(np.abs(vals[valid]).max()) if valid.any() else 0.0
        tr = _auction.make_transform(self.problem, prob.m, vals.dtype,
                                     vmax_abs, int_exact=prob.int_exact)
        theta = (self.theta if self.theta is not None
                 else _auction.device_theta_default(prob.n))
        e0, e_min, theta = _auction.default_eps_schedule(
            vals.dtype, vmax_abs, prob.m, tr.scale,
            eps_min=self.eps_min, eps_start=self.eps_start, theta=theta,
            int_exact=prob.int_exact)
        max_iter = (self.max_iter if self.max_iter is not None
                    else _auction.default_max_iter(prob.n))
        if warm_prices is None:
            p0 = jnp.zeros((prob.m,), prob.vals.dtype)
        else:
            p0 = jnp.asarray(_auction.validate_warm_prices(warm_prices,
                                                           prob.m),
                             prob.vals.dtype)
        return tr, e0, e_min, theta, max_iter, p0

    def _resolve_mode(self) -> str:
        from sslap_tpu import hybrid as _hybrid
        if np.asarray(self.problem_spec.vals).dtype == np.float64:
            # float64 rides the host CPU path only: JAX disables x64 by
            # default and the device engines are f32/int32.  Without a
            # toolchain the pure-numpy engine (gs_host.py) serves it,
            # slower but exact.
            if self.mode in ("device", "hybrid", "sharded", "overlapped",
                             "sharded_hybrid"):
                raise ValueError(
                    "float64 costs are solved on the native CPU path; use "
                    "mode='cpu' or 'auto'")
            return "cpu"
        if self.mode != "auto":
            return self.mode
        # The hybrid device path wins large square instances, the native
        # serial GS wins small and mid sizes where the price table is
        # cache-resident and a device dispatch's fixed cost dominates.
        # Hosts without a toolchain get the device path at every size
        # (the numpy GS is ~30x slower than the native one).
        prob = self.problem_spec
        if not _hybrid.native_available():
            return "device"
        if prob.n == prob.m and prob.n >= DEFAULT_CROSSOVER:
            return "hybrid"
        return "cpu"

    def _resolve_engine(self, mode: Optional[str] = None,
                        warm: bool = False) -> str:
        if self.engine != "auto":
            return self.engine
        # Auto never picks 'dense' for a warm-started solve: the dense
        # engine's phase warm starts are internal and it rejects
        # warm_prices -- auto must not break the uniform warm contract.
        if mode == "hybrid" and not warm:
            # Dense-dominated instances stream as contiguous dense [C, m]
            # device rounds instead of per-entry ELL gathers -- the
            # batched dense engine serves B=1 through the same path.
            from sslap_tpu import dense_batch as _db
            prob = self.problem_spec
            nnz = int(np.asarray(prob.nvalid).sum())
            if (nnz * 4 >= prob.n * prob.m
                    and _db.dense_hybrid_available(prob)):
                return "dense"
        # The kappa-shortlist engine lost to exact compact rounds at 1M on
        # the earlier accelerator -- stale-tau certification fails en
        # masse at phase starts and floods the rescan backlog.  compact is
        # the default everywhere; 'candidates' stays available explicitly.
        # Not yet compared on the H100.
        return "compact"

    def _solve_dense_hybrid(self, prob, t0, warm_prices) -> "AuctionSolution":
        """Single instance through the batched dense-chunk engine (B=1):
        dense [1, n, m] device rounds + one native GS tail.  The dense
        meta already folds empty rows into ``unassigned`` and computes
        the exact objective host-side."""
        if warm_prices is not None:
            raise ValueError(
                "engine='dense' does not support warm_prices (its phase "
                "warm starts are internal); use the default engine")
        from sslap_tpu import dense_batch as _db
        from sslap_tpu.batch import stack_problems
        if not _db.dense_hybrid_available(prob):
            raise ValueError(
                "engine='dense' needs a square f32/int32 problem with "
                "n <= 16384 and the native toolchain")
        # The [1, n, K] stack is pure host copies of the (fixed) problem
        # arrays -- ~150 MB per call at dense 4096 -- so build it once per
        # solver (round 5; same one-solver-one-problem contract as the
        # rest of _device_cache).
        stacked = self._device_cache.get("dense_stacked")
        if stacked is None:
            stacked = stack_problems([prob])
            self._device_cache["dense_stacked"] = stacked
        sols, metas, prices = _db.solve_batched_dense_hybrid(
            stacked, problem=self.problem,
            eps_start=self.eps_start, eps_min=self.eps_min,
            theta=(5.0 if self.theta is None else self.theta),
            max_iter=self.max_iter, return_prices=True,
            device_cache=self._device_cache)
        self.prices = prices[0]
        # meta 'mode' stays the REQUESTED mode (the API contract every
        # test and caller keys on); the engine is disclosed separately.
        self.meta = dict(metas[0], mode="hybrid", engine="dense",
                         time=time.perf_counter() - t0)
        return AuctionSolution(sol=sols[0], meta=self.meta,
                               prices=self.prices)

    def solve(self, warm_prices=None,
              warm_relax: float = 1.0,
              warm_mode: str = "raw") -> AuctionSolution:
        """Solve; optionally warm-started from a previous solution's
        ``prices`` (transformed-space duals, >= 0 on every mode).

        ``warm_mode``: ``'raw'`` uses the warm prices as given (after
        ``warm_relax``); ``'fr'`` first applies the forward-reverse dual
        tightening (auction.fr_tighten) against THIS solve's costs --
        prices can only fall, repairing duals that pattern churn or value
        drift left above the new market level (the forward auction's
        structural warm-start hard case; PERF.md round 4 measured 41-49M
        bid blowups from chained raw warm starts).  Supported on the
        'hybrid'/'cpu' engines; ignored when warm_prices is None.

        ``warm_relax``: multiply the warm prices by this factor in
        (0, 1].  For PATTERN-churned re-solves (tracking workloads where
        edges appear/vanish), raw eps-tight duals are the forward
        auction's hard case -- prices cannot move down, so displaced
        rows' eviction chains find no slack and can cost MORE than a
        cold solve.  Scaling by ~0.9-0.95 restores per-column headroom
        proportional to each price while keeping the dual information:
        measured 2.3x fewer bids than cold at 100k/0.1% churn
        (PERF.md round 4), where raw warm duals matched cold.  Pure
        value drift keeps the default 1.0 (and a drift-matched
        eps_start ~ 4x the drift)."""
        prob = self.problem_spec
        if warm_mode not in ("raw", "fr"):
            raise ValueError("warm_mode must be 'raw' or 'fr'")
        warm_fr = 0
        if warm_prices is not None:
            if not (0.0 < warm_relax <= 1.0):
                raise ValueError("warm_relax must be in (0, 1]")
            warm_prices = _auction.validate_warm_prices(warm_prices, prob.m)
            if warm_relax != 1.0:
                warm_prices = np.asarray(warm_prices) * warm_relax
            if warm_mode == "fr":
                # 2 sweeps: the second uses the lowered prices to raise
                # profits and settle any cascade; the native loop
                # early-exits at the fixed point anyway.
                warm_fr = 2
        t0 = time.perf_counter()
        if self.cardinality_check and not _feas.is_feasible(prob):
            raise InfeasibleError(
                "no perfect matching exists for this sparsity pattern "
                "(detected by Hopcroft-Karp cardinality check; pass "
                "cardinality_check=False to attempt anyway)")
        mode = self._resolve_mode()
        if mode in ("sharded", "overlapped", "sharded_hybrid"):
            # One-flag access to the distribution layer (VERDICT round-1
            # weak item 7): row-shard over the default mesh of all local
            # devices.  For explicit meshes / partition strategies use
            # parallel.auction_solve_sharded / auction_solve_overlapped /
            # auction_solve_sharded_hybrid (the performance path: tiered
            # compaction + compact active-set exchanges + host GS tail).
            from sslap_tpu import parallel as _par
            fn = {"sharded": _par.auction_solve_sharded,
                  "overlapped": _par.auction_solve_overlapped,
                  "sharded_hybrid": _par.auction_solve_sharded_hybrid}[mode]
            # Hand over the already-built ELLProblem (dtype applied at
            # construction): no COO round-trip, no second O(nnz) ingest.
            extra = ({"wide_rounds": self.wide_rounds, "warm_fr": warm_fr}
                     if mode == "sharded_hybrid" else {})
            res = fn(self.problem_spec,
                     problem=self.problem,
                     eps_start=self.eps_start, eps_min=self.eps_min,
                     theta=self.theta, theta_tail=self.theta_tail,
                     tail_phases=self.tail_phases,
                     max_iter=self.max_iter,
                     cardinality_check=False, warm_prices=warm_prices,
                     **extra)
            self.prices = res.get("prices")
            self.meta = res["meta"]
            return res
        if mode in ("hybrid", "cpu"):
            from sslap_tpu import hybrid as _hybrid
            n_empty = int((np.asarray(prob.nvalid) == 0).sum())
            engine = self._resolve_engine(mode, warm=warm_prices is not None)
            if engine == "dense":
                if mode != "hybrid":
                    raise ValueError(
                        "engine='dense' runs dense device rounds with a "
                        "native GS tail -- it requires mode='hybrid'")
                return self._solve_dense_hybrid(prob, t0, warm_prices)
            sol, prices, hmeta = _hybrid.solve_hybrid(
                prob, problem=self.problem, eps_start=self.eps_start,
                eps_min=self.eps_min, theta=self.theta,
                theta_tail=self.theta_tail,
                tail_phases=self.tail_phases,
                max_iter=self.max_iter, mode=mode,
                warm_prices=warm_prices,
                keep_assignment=self.keep_assignment, engine=engine,
                device_cache=self._device_cache,
                wide_rounds=self.wide_rounds,
                fine_ladder=self.fine_ladder,
                warm_fr=warm_fr, gs_engine=self.gs_engine)
            unassigned = hmeta["unassigned"] + n_empty
            # AND with the engine's own verdict: solve_hybrid also requires
            # bids >= 0 (GS budget not exhausted) and eps_min reached --
            # unassigned == 0 alone would report a truncated-at-higher-eps
            # assignment as optimal.
            soln_found = unassigned == 0 and hmeta.get("soln_found", True)
            self.prices = prices
            self.meta = dict(hmeta, unassigned=unassigned,
                             soln_found=soln_found,
                             obj=(_objective_host(prob, sol)
                                  if soln_found else None),
                             time=time.perf_counter() - t0)
            return AuctionSolution(sol=sol, meta=self.meta,
                                   prices=self.prices)
        tr, e0, e_min, theta, max_iter, p0 = self._prepare(warm_prices)
        vals_t = tr.apply(prob.vals)
        if prob.n == prob.m and self.keep_assignment:
            # Square problems take the tiered active-compaction drivers:
            # compact.py (exact scans) or candidate.py (kappa-shortlist
            # rounds at wide tiers); round cost scales with the live
            # active set instead of O(n*K) either way.
            engine = self._resolve_engine()
            if engine == "dense":
                raise ValueError(
                    "engine='dense' runs dense device rounds with a "
                    "native GS tail -- it requires mode='hybrid'")
            res = _solve_tiered_jit(prob.cols, vals_t, prob.valid,
                                    prob.nvalid, p0, e0, e_min, theta,
                                    max_iter, engine=engine)
        else:
            # keep_assignment=False (reference-style reset-per-phase) has no
            # tiered equivalent -- the tiered driver's phase-start round IS
            # the warm-started violator scan -- so the A/B knob routes
            # through the plain Jacobi driver instead of being ignored.
            res = _solve_jit(prob.cols, vals_t, prob.valid, prob.nvalid, p0,
                             e0, e_min, theta, max_iter,
                             keep_assignment=self.keep_assignment)
        sol = np.asarray(res.sigma)
        t1 = time.perf_counter()
        # solve_ell's count excludes rows with no valid entries; they are
        # genuinely unassignable, so fold them back in here.
        n_empty = int((np.asarray(prob.nvalid) == 0).sum())
        unassigned = int(np.asarray(res.unassigned)) + n_empty
        soln_found = unassigned == 0
        self.prices = np.asarray(res.prices)
        self.meta = {
            "obj": _objective_host(prob, sol) if soln_found else None,
            "its": int(np.asarray(res.rounds)),
            "phases": int(np.asarray(res.phases)),
            "soln_found": soln_found,
            "final_eps": (float(np.asarray(res.final_eps)) / tr.scale),
            "unassigned": unassigned,
            "time": t1 - t0,
            "mode": "device",
        }
        return AuctionSolution(sol=sol, meta=self.meta, prices=self.prices)


import functools


@functools.partial(jax.jit, static_argnames=("keep_assignment",))
def _solve_jit(cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta,
               max_iter, keep_assignment=True):
    return _auction.solve_ell(cols, vals_t, valid, nvalid, p0,
                              eps0, eps_min, theta, max_iter,
                              keep_assignment=keep_assignment)


@functools.partial(jax.jit, static_argnames=("engine",))
def _solve_tiered_jit(cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta,
                      max_iter, engine="compact"):
    if engine == "candidates":
        from sslap_tpu import candidate as _candidate
        res, _ = _candidate.solve_ell_candidates(
            cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta, max_iter)
        return res
    from sslap_tpu import compact as _compact
    res, _ = _compact.solve_ell_tiered(cols, vals_t, valid, nvalid, p0,
                                       eps0, eps_min, theta, max_iter)
    return res


def auction_solve(
    mat=None,
    *,
    loc=None,
    val=None,
    shape: Optional[Tuple[int, int]] = None,
    problem=_UNSET,
    eps_start=_UNSET,
    eps_min=_UNSET,
    theta=_UNSET,
    max_iter=_UNSET,
    cardinality_check=_UNSET,
    dtype=_UNSET,
    mode=_UNSET,
    keep_assignment=_UNSET,
    engine=_UNSET,
    config=None,
) -> AuctionSolution:
    """Solve a (sparse) linear assignment problem with the auction algorithm.

    Args:
      mat: dense [n, m] cost matrix; negative / NaN entries are forbidden.
      loc, val: COO sparse alternative -- int [nnz, 2] coords + [nnz] costs
        (all >= 0); ``shape`` optionally fixes (n, m).
      problem: 'min' (default) or 'max' objective.
      eps_start, eps_min, theta: epsilon-scaling schedule overrides.
      max_iter: cap on Jacobi rounds (safety valve for infeasible inputs when
        cardinality_check=False).
      cardinality_check: run the Hopcroft-Karp feasibility pre-check and
        raise InfeasibleError if no perfect matching exists.
      dtype: force on-device dtype (int32 = exact, float32 = eps-optimal).
      mode: 'auto' (default), 'device' (pure jitted Jacobi), 'hybrid'
        (device bulk + native host tail, fastest for large single
        instances), or 'cpu' (pure native Gauss-Seidel reference).

    Returns:
      AuctionSolution with 'sol' (int array, row -> col, -1 if unassigned),
      'meta' ({'obj', 'its', 'phases', 'soln_found', 'final_eps',
      'unassigned', 'time'}), and 'prices' (final duals, transformed
      space; reusable as warm_prices).
    """
    solver = AuctionSolver(
        mat, loc=loc, val=val, shape=shape, problem=problem,
        eps_start=eps_start, eps_min=eps_min, theta=theta, max_iter=max_iter,
        cardinality_check=cardinality_check, dtype=dtype, mode=mode,
        keep_assignment=keep_assignment, engine=engine, config=config)
    return solver.solve()


def hopcroft_solve(mat=None, *, loc=None, val=None,
                   shape: Optional[Tuple[int, int]] = None,
                   warm=None) -> np.ndarray:
    """Standalone Hopcroft-Karp maximum bipartite matching over the sparsity
    pattern (values ignored; reference R3, SURVEY.md SS4.3).

    ``warm`` optionally seeds augmentation from a previous matching (int
    array [n]: col per row, -1 unmatched) -- e.g. the previous frame of a
    tracking workload.  Edges absent from the current pattern and duplicate
    columns are dropped before seeding, so any stale matching is safe.

    Returns int array [n]: matched column per row, -1 if unmatched.
    """
    if mat is not None:
        prob = _ingest.from_dense(mat)
    else:
        if loc is None:
            raise ValueError("pass mat= or loc= (val optional for matching)")
        if val is None:
            val = np.zeros(np.asarray(loc).shape[0], np.int32)
        prob = _ingest.from_coo(loc, val, shape=shape,
                                require_nonnegative=False)
    init = None
    if warm is not None:
        init = _feas.sanitize_matching(prob, np.asarray(warm))
    match_row, _, _ = _feas.hopcroft_karp(prob, init_match=init)
    return match_row.astype(np.int64)


def linear_sum_assignment(cost, maximize: bool = False):
    """scipy-compatible adapter: returns (row_ind, col_ind) for a dense cost
    matrix (no forbidden-entry convention -- all entries valid; shift applied
    internally so negatives are allowed, matching scipy semantics).  Tall
    matrices (rows > cols) are solved transposed, as scipy allows: the
    returned index arrays then have length ``cols`` with row_ind sorted."""
    cost = np.asarray(cost, np.float64)
    shift = min(0.0, float(cost.min())) if cost.size else 0.0
    n, m = cost.shape
    if n > m:
        res = auction_solve(cost.T - shift,
                            problem="max" if maximize else "min")
        col_to_row = res["sol"]            # [m]: original row per column
        order = np.argsort(col_to_row, kind="stable")
        return col_to_row[order], order
    res = auction_solve(cost - shift, problem="max" if maximize else "min")
    sol = res["sol"]
    rows = np.arange(n)
    return rows, sol
