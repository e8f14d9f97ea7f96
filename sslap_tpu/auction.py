"""Jacobi auction solver with epsilon-scaling (pure JAX orchestration layer).

Implements Bertsekas' forward auction in its *Jacobi* (all-unassigned-rows-
bid-simultaneously) form, which is the variant that maps onto wide vector
hardware and onto multi-device meshes (SURVEY.md SS8.0).  The reference
(sslap's Cython ``AuctionSolver``, SURVEY.md SS3a R2 / SS4.1) runs a serial
Gauss-Seidel bid loop; a literal translation would be a scalar loop that XLA
cannot tile, so instead every round:

  1. BID:    every row computes top-2 of (a_ij - p_j) over its nnz and a bid
             on its best column;
  2. RESOLVE: per column, the max bid wins, ties -> lowest row index
             (deterministic, documented tie-break);
  3. COMMIT: winning columns raise prices, evict previous owners.

Shapes are fully static: *all* rows compute bids every round and non-bidding
rows are masked out of the commit scatter (SURVEY.md SS8.2 item 1).

Exactness: integer costs run on int32, pre-scaled by (n+1) with the epsilon
schedule ending at eps = 1, which yields an exactly optimal assignment
(standard auction-algorithm result; SURVEY.md SS8.0).  Float costs run on
f32 and are eps-optimal within n * eps_min.

Epsilon-complementary-slackness (eps-CS) invariant maintained by every
round and checked in tests/test_properties.py:
    a[i, sigma(i)] - p[sigma(i)] >= max_j (a[i, j] - p[j]) - eps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


# Sentinel used *only inside max-reductions / masked selects*; never fed into
# bid arithmetic (see the has-second-best select below), so no overflow.
_INT_NEG = -(2 ** 30)
_I32_MAX = 2 ** 31 - 1


def neg_sentinel(dtype) -> jax.Array:
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        return jnp.asarray(_INT_NEG, dtype)
    return jnp.asarray(jnp.finfo(dtype).min / 4, dtype)


def neg_sentinel_value(dtype):
    """Python-scalar twin of neg_sentinel (for fill_value args, which must
    be concrete)."""
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        return _INT_NEG
    return float(jnp.finfo(dtype).min / 4)


def neg_sentinel_np(dtype) -> np.ndarray:
    """Numpy twin of neg_sentinel for HOST-side code paths.  neg_sentinel
    builds a jax array; np.asarray() on it is a device fetch that waits on
    whatever the device is running.  Host code must never touch the device
    for a constant."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer):
        return np.asarray(_INT_NEG, dtype)
    return np.asarray(np.finfo(dtype).min / 4, dtype)


class AuctionState(NamedTuple):
    """Carried state of the scaled auction.  A tiny pytree -- snapshotting it
    (prices, sigma, owner, eps) is the checkpoint/warm-start payload
    (SURVEY.md SS6 'Checkpoint / resume')."""

    prices: jax.Array   # [m]    dtype = solver dtype
    owner: jax.Array    # [m]    int32 global row owning column j, -1 free
    sigma: jax.Array    # [n]    int32 column assigned to row i, -1 free
    eps: jax.Array      # scalar dtype
    rounds: jax.Array   # scalar int32, total Jacobi rounds so far
    phases: jax.Array   # scalar int32, eps phases completed


class SolveResult(NamedTuple):
    sigma: jax.Array        # [n] int32
    prices: jax.Array       # [m] dtype
    rounds: jax.Array       # int32
    phases: jax.Array       # int32
    final_eps: jax.Array    # dtype
    unassigned: jax.Array   # int32 rows left unassigned (0 => solution found)


# ---------------------------------------------------------------------------
# Round pieces.  Kept as separate pure functions so the sharded path
# (parallel/sharded.py) can reuse the resolve/commit logic unchanged.
# ---------------------------------------------------------------------------


def compute_bids(
    cols: jax.Array,       # [n, K] int32
    vals_t: jax.Array,     # [n, K] transformed (maximization) values
    valid: jax.Array,      # [n, K] bool
    nvalid: jax.Array,     # [n] int32
    prices: jax.Array,     # [m]
    sigma: jax.Array,      # [n] int32
    eps: jax.Array,        # scalar
    bigp: jax.Array,       # scalar: finite stand-in for "-inf second best"
) -> Tuple[jax.Array, jax.Array]:
    """Per-row top-2 reduction and bid (reference hot loop, SURVEY.md SS4.1
    'BIDDING').  Returns (tgt [n] int32 target column, or m for non-bidders;
    bid [n] dtype new price offered)."""
    n, K = cols.shape
    m = prices.shape[0]
    dtype = vals_t.dtype
    neg = neg_sentinel(dtype)

    w = jnp.where(valid, vals_t - prices[cols], neg)            # [n, K]
    slot = jnp.argmax(w, axis=1)                                # first max
    onehot = jnp.arange(K, dtype=jnp.int32)[None, :] == slot[:, None]
    v1 = jnp.max(w, axis=1)
    v2 = jnp.max(jnp.where(onehot, neg, w), axis=1)
    # Rows with a single valid entry have no real second-best: use v1 - bigp,
    # which keeps bids finite *and* strictly increasing on re-bid
    # (new price = p + (v1 - v2) + eps = p + bigp + eps).
    v2 = jnp.where(nvalid >= 2, v2, v1 - bigp)
    a_star = jnp.sum(jnp.where(onehot, vals_t, jnp.zeros_like(vals_t)), axis=1)
    jstar = jnp.sum(jnp.where(onehot, cols, 0), axis=1).astype(jnp.int32)
    bid = a_star - v2 + eps                                     # = p* + v1 - v2 + eps

    bidding = (sigma < 0) & (nvalid > 0)
    tgt = jnp.where(bidding, jstar, jnp.int32(m))               # m => dropped
    return tgt, bid


def resolve_bids(
    tgt: jax.Array,        # [n_local] int32 in [0, m] (m = no bid)
    bid: jax.Array,        # [n_local]
    m: int,
    row_ids: jax.Array,    # [n_local] int32 *global* row ids
) -> Tuple[jax.Array, jax.Array]:
    """Conflict-resolving reduction of bids into per-column (best, winner).
    Deterministic tie-break: highest bid, then lowest global row id
    (reference 'ASSIGNMENT' phase, SURVEY.md SS4.1; SS8.2 item 2)."""
    dtype = bid.dtype
    neg = neg_sentinel(dtype)
    best = jnp.full((m,), neg, dtype).at[tgt].max(bid, mode="drop")
    is_best = bid == best.at[tgt].get(
        mode="fill",
        fill_value=neg_sentinel_value(dtype))  # tgt == m -> neg -> False
    cand = jnp.where(is_best, row_ids, jnp.int32(_I32_MAX))
    winner = (
        jnp.full((m,), _I32_MAX, jnp.int32).at[tgt].min(cand, mode="drop")
    )
    return best, winner


def commit_bids(
    best: jax.Array,       # [m] combined best bid per column (or neg)
    winner: jax.Array,     # [m] combined winning global row id
    prices: jax.Array,     # [m]
    owner: jax.Array,      # [m] int32 global row id, -1 free
    sigma: jax.Array,      # [n_local] int32
    row_offset,            # python int or traced int32: first local row id
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Apply resolved bids: raise prices, install winners, evict previous
    owners.  ``sigma`` may be a local shard of rows; winner/owner carry
    global row ids and are translated through ``row_offset``."""
    m = prices.shape[0]
    n_local = sigma.shape[0]
    neg = neg_sentinel(prices.dtype)
    has = best > (neg // 2 if jnp.issubdtype(prices.dtype, jnp.integer)
                  else neg / 2)
    new_prices = jnp.where(has, best, prices)

    col_idx = jnp.arange(m, dtype=jnp.int32)

    def local_scatter_idx(global_rows, mask):
        loc = global_rows - jnp.int32(row_offset)
        ok = mask & (loc >= 0) & (loc < n_local)
        # n_local is out of bounds => dropped; avoids negative-index wrap.
        return jnp.where(ok, loc, jnp.int32(n_local))

    evict_idx = local_scatter_idx(owner, has & (owner >= 0))
    sigma = sigma.at[evict_idx].set(-1, mode="drop")
    win_idx = local_scatter_idx(winner, has)
    sigma = sigma.at[win_idx].set(col_idx, mode="drop")
    new_owner = jnp.where(has, winner, owner)
    return new_prices, new_owner, sigma


def jacobi_round(
    cols, vals_t, valid, nvalid,
    prices, owner, sigma, eps, bigp,
    row_offset=0,
    combine: Optional[Callable[[jax.Array, jax.Array],
                               Tuple[jax.Array, jax.Array]]] = None,
):
    """One full Jacobi auction round.  ``combine`` merges per-shard
    (best, winner) across devices (identity on a single device; pmax/pmin in
    parallel/sharded.py; injectable fake in tests per SURVEY.md SS5.2c)."""
    m = prices.shape[0]
    n_local = sigma.shape[0]
    row_ids = jnp.int32(row_offset) + jnp.arange(n_local, dtype=jnp.int32)
    tgt, bid = compute_bids(
        cols, vals_t, valid, nvalid, prices, sigma, eps, bigp)
    best, winner = resolve_bids(tgt, bid, m, row_ids)
    if combine is not None:
        best, winner = combine(best, winner)
    return commit_bids(best, winner, prices, owner, sigma, row_offset)


# ---------------------------------------------------------------------------
# Rectangular (n < m) support: implicit dummy rows.
#
# A rectangular LAP is equivalent to the square m x m problem with (m - n)
# dummy rows connected to *every* column at constant value 0: the dummy part
# of the objective is constant, so the square optimum restricted to real
# rows is the rectangular optimum.  Materializing those rows would blow the
# ELL layout up to dense [m, m]; instead they are handled analytically.
# All unassigned dummies are interchangeable, so one Jacobi sub-step places
# them on the u_d cheapest columns at price t + eps, where t is the
# (u_d+1)-th smallest price.  eps-CS check for each dummy: its value is
# -(t + eps) and the best alternative is -t (every column cheaper than t was
# just grabbed), i.e. exactly within eps.  Prices rise by >= eps on every
# grabbed column, so the standard termination argument is unaffected.
# Columns held by dummies carry owner == DUMMY_OWNER.
# ---------------------------------------------------------------------------

DUMMY_OWNER = -2


def dummy_grab_step(
    prices: jax.Array,     # [m]
    owner: jax.Array,      # [m] int32 (-1 free, -2 dummy, >=0 real row)
    sigma: jax.Array,      # [n_local] int32
    eps: jax.Array,
    n_dummy: int,          # static: m - n
    row_offset=0,
):
    """Place all currently-unassigned implicit dummy rows.  Re-grabbing an
    already-dummy-held column is a harmless price raise (progress still
    >= eps per round); real owners of grabbed columns are evicted."""
    m = prices.shape[0]
    n_local = sigma.shape[0]
    held = jnp.sum(owner == DUMMY_OWNER).astype(jnp.int32)
    u_d = jnp.int32(n_dummy) - held
    order = jnp.argsort(prices, stable=True)   # ties -> lowest column index
    rank = (jnp.zeros((m,), jnp.int32)
            .at[order].set(jnp.arange(m, dtype=jnp.int32)))
    grab = rank < u_d
    t = prices[order[jnp.clip(u_d, 0, m - 1)]]

    loc = owner - jnp.int32(row_offset)
    ok = grab & (owner >= 0) & (loc >= 0) & (loc < n_local)
    sigma = sigma.at[jnp.where(ok, loc, jnp.int32(n_local))].set(
        -1, mode="drop")
    owner = jnp.where(grab, jnp.int32(DUMMY_OWNER), owner)
    prices = jnp.where(grab, t + eps, prices)
    return prices, owner, sigma, u_d


def count_unassigned_dummies(owner: jax.Array, n_dummy: int) -> jax.Array:
    held = jnp.sum(owner == DUMMY_OWNER).astype(jnp.int32)
    return jnp.int32(n_dummy) - held


def unassign_violators(
    cols, vals_t, valid,
    prices, owner, sigma, eps,
    n_dummy: int,
    combine_owner: Optional[Callable[[jax.Array], jax.Array]] = None,
):
    """Unassign only the (row, col) pairs violating eps-CS for the *new*
    (smaller) eps, keeping the rest of the assignment as a warm start.

    This is the auction algorithm's standard warm-started eps-scaling: the
    surviving partial assignment satisfies eps-CS for the new eps and prices
    never decrease, so correctness/termination arguments are unchanged.
    Each phase then re-auctions only the violating rows instead of all n
    (the reference resets every phase).  Measured impact on random sparse
    instances is roughly neutral (~50-70% of rows violate at theta = 5; see
    PERF.md), but the warm start is what phase truncation and warm-priced
    re-solves build on.

    ``sigma`` may be a local row shard; ``owner``/``prices`` are replicas.
    In the sharded path each shard frees only its own rows' columns, so the
    caller passes ``combine_owner`` = lax.pmin over the mesh axis to
    re-converge the owner replicas (freed = -1 < any row id; dummy checks
    are computed identically on every shard from replicated prices).
    """
    m = prices.shape[0]
    dtype = vals_t.dtype
    neg = neg_sentinel(dtype)
    w = jnp.where(valid, vals_t - prices[cols], neg)
    v1 = jnp.max(w, axis=1)
    cur_hit = (cols == sigma[:, None]) & valid
    cur = jnp.sum(jnp.where(cur_hit, w, jnp.zeros_like(w)), axis=1)
    viol = (sigma >= 0) & (cur < v1 - eps)
    owner = owner.at[jnp.where(viol, sigma, jnp.int32(m))].set(
        -1, mode="drop")
    sigma = jnp.where(viol, jnp.int32(-1), sigma)
    if n_dummy > 0:
        # Dummy value on column j is -p_j; eps-CS requires
        # p[sigma_d] <= min(p) + eps.
        minp = jnp.min(prices)
        viol_d = (owner == DUMMY_OWNER) & (prices > minp + eps)
        owner = jnp.where(viol_d, jnp.int32(-1), owner)
    if combine_owner is not None:
        owner = combine_owner(owner)
    return owner, sigma


# ---------------------------------------------------------------------------
# Epsilon-scaled driver (component T5; reference solve loop SURVEY.md SS4.1).
# ---------------------------------------------------------------------------


def _next_eps(eps, theta, eps_min, theta_tail=None, tail_phases: int = 2):
    """Geometric eps descent, optionally with a MIXED tail schedule.

    Pure: eps -> max(eps/theta, eps_min).

    Mixed (theta_tail > 1): descend by ``theta`` while eps is above
    eps_min * theta_tail**tail_phases (clamping AT that threshold), then
    by ``theta_tail`` for the last ~tail_phases phases.  Rationale
    (PERF.md round-3 theta A/B): the host-GS tail's bid count is set by
    the FINAL eps drop ratio, not the early ones -- theta=10 all the way
    blew the sibling instance's tail to 8.7M bids where ratio-3 final
    drops hold it near 1M, at the cost of ~2 extra (cheap) phase starts.

    ``theta_tail`` is a traced scalar; values <= 1 disable the tail
    stage (single compiled program serves both schedules).
    """
    is_int = jnp.issubdtype(eps.dtype, jnp.integer)
    pure = jnp.maximum(eps // theta if is_int else eps / theta, eps_min)
    if theta_tail is None:
        return pure
    theta_tail = jnp.asarray(theta_tail, eps.dtype)
    thresh = eps_min * theta_tail ** tail_phases
    if is_int:
        hi = jnp.maximum(eps // theta, thresh)
        lo = jnp.maximum(eps // jnp.maximum(theta_tail, 1), eps_min)
    else:
        hi = jnp.maximum(eps / theta, thresh)
        lo = jnp.maximum(eps / jnp.maximum(theta_tail, 1e-9), eps_min)
    mixed = jnp.where(eps > thresh, hi, lo)
    one = jnp.asarray(1, eps.dtype)
    return jnp.where(theta_tail > one, mixed, pure)


def solve_ell(
    cols: jax.Array,
    vals_t: jax.Array,
    valid: jax.Array,
    nvalid: jax.Array,
    p0: jax.Array,
    eps0: jax.Array,
    eps_min: jax.Array,
    theta: jax.Array,
    max_iter: jax.Array,
    combine: Optional[Callable] = None,
    count_unassigned: Optional[Callable] = None,
    row_offset=0,
    n_global: Optional[int] = None,
    bigp: Optional[jax.Array] = None,
    on_round: Optional[Callable] = None,
    keep_assignment: bool = True,
    combine_owner: Optional[Callable] = None,
    theta_tail=None,
    tail_phases: int = 2,
) -> SolveResult:
    """Scaled auction over an ELL block.  Pure and jittable; vmap-able over a
    leading batch axis (batch.py) and shard_map-able over rows
    (parallel/sharded.py) via the ``combine`` / ``count_unassigned`` /
    ``row_offset`` injection points.

    All rows bid every round; assigned rows are masked at commit so every
    shape is static (SURVEY.md SS8.2 item 1)."""
    n, K = cols.shape
    m = p0.shape[0]
    n_dummy = m - (n_global if n_global is not None else n)  # static
    dtype = vals_t.dtype
    neg = neg_sentinel(dtype)
    pos = -neg

    if bigp is None:
        # Local reduction; the sharded path passes a globally-reduced bigp in
        # so every shard sees identical bid arithmetic.
        vmax = jnp.max(jnp.where(valid, vals_t, neg))
        vmin = jnp.min(jnp.where(valid, vals_t, pos))
        one = jnp.asarray(1, dtype)
        bigp = jnp.maximum(vmax - vmin, jnp.zeros_like(one)) + one
    else:
        bigp = jnp.asarray(bigp, dtype)

    eps0 = jnp.maximum(jnp.asarray(eps0, dtype), jnp.asarray(eps_min, dtype))
    eps_min = jnp.asarray(eps_min, dtype)
    theta = jnp.asarray(theta, dtype)
    max_iter = jnp.asarray(max_iter, jnp.int32)

    if count_unassigned is None:
        def count_unassigned(sigma):  # noqa: F811 - default local reduction
            return jnp.sum((sigma < 0) & (nvalid > 0)).astype(jnp.int32)

    def round_fn(st: AuctionState) -> AuctionState:
        prices, owner, sigma = jacobi_round(
            cols, vals_t, valid, nvalid,
            st.prices, st.owner, st.sigma, st.eps, bigp,
            row_offset=row_offset, combine=combine,
        )
        if n_dummy > 0:
            prices, owner, sigma, _ = dummy_grab_step(
                prices, owner, sigma, st.eps, n_dummy, row_offset=row_offset)
        st = st._replace(prices=prices, owner=owner, sigma=sigma,
                         rounds=st.rounds + 1)
        if on_round is not None:
            # Opt-in observability (SURVEY.md SS6 'Metrics / logging'):
            # host callback with (round, unassigned, eps) -- adds a host
            # sync, so off by default.
            jax.debug.callback(on_round, st.rounds,
                               count_unassigned(st.sigma), st.eps)
        return st

    def phase_cond(st: AuctionState):
        left = count_unassigned(st.sigma)
        if n_dummy > 0:
            left = left + count_unassigned_dummies(st.owner, n_dummy)
        return (left > 0) & (st.rounds < max_iter)

    def outer_body(carry):
        st, _ = carry
        st = lax.while_loop(phase_cond, round_fn, st)
        finished = (st.eps <= eps_min) | (st.rounds >= max_iter)
        new_eps = jnp.where(finished, st.eps,
                            _next_eps(st.eps, theta, eps_min,
                                      theta_tail=theta_tail,
                                      tail_phases=tail_phases))
        if keep_assignment:
            # Warm-started phase: keep pairs satisfying eps-CS at new_eps,
            # unassign only violators (see unassign_violators).
            def advance(st):
                owner, sigma = unassign_violators(
                    cols, vals_t, valid, st.prices, st.owner, st.sigma,
                    new_eps, n_dummy, combine_owner=combine_owner)
                return st._replace(owner=owner, sigma=sigma)
            st = lax.cond(finished, lambda s: s, advance, st)
        else:
            # Reference-style full reset (kept for A/B testing).
            st = lax.cond(
                finished, lambda s: s,
                lambda s: s._replace(
                    sigma=jnp.full_like(s.sigma, -1),
                    owner=jnp.full_like(s.owner, -1)),
                st)
        st = st._replace(eps=new_eps, phases=st.phases + 1)
        return st, finished

    def outer_cond(carry):
        _, finished = carry
        return jnp.logical_not(finished)

    init = AuctionState(
        prices=p0.astype(dtype),
        owner=jnp.full((m,), -1, jnp.int32),
        sigma=jnp.full((n,), -1, jnp.int32),
        eps=eps0,
        rounds=jnp.int32(0),
        phases=jnp.int32(0),
    )
    st, _ = lax.while_loop(outer_cond, outer_body, (init, jnp.bool_(False)))
    # Rows with no valid entries (genuinely empty, or shard padding) are
    # excluded here; the API layer re-adds genuinely-empty rows host-side.
    unassigned = count_unassigned(st.sigma)
    return SolveResult(
        sigma=st.sigma, prices=st.prices, rounds=st.rounds,
        phases=st.phases, final_eps=st.eps, unassigned=unassigned,
    )


# ---------------------------------------------------------------------------
# Transform helpers: min/max objective and integer scaling.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Transform:
    """How raw costs map to the internal maximization values:
    ``v = sign * a * scale``.  Integer costs scale by (n+1) so that the final
    eps = 1 phase yields an exactly optimal assignment."""
    sign: int
    scale: int

    def apply(self, vals: jax.Array) -> jax.Array:
        s = jnp.asarray(self.sign * self.scale, vals.dtype)
        return vals * s


def make_transform(problem: str, size: int, dtype, vmax_abs: float,
                   int_exact: bool = False) -> Transform:
    """``size`` is the effective square dimension (= m: rectangular problems
    are implicitly square-extended, so the eps-optimality bound is m * eps).
    ``int_exact``: integer values stored in float64 (ingest routed them
    there because the int32 range was exceeded) -- scaled like the integer
    path, exact while every intermediate stays below 2**53."""
    if problem not in ("min", "max"):
        raise ValueError(f"problem must be 'min' or 'max', got {problem!r}")
    sign = 1 if problem == "max" else -1
    if int_exact:
        scale = size + 1
        if vmax_abs * scale >= 2 ** 50:
            raise ValueError(
                f"integer costs too large for the exact float64 path: "
                f"max|cost| * (m+1) = {vmax_abs * scale:.3g} >= 2**50")
        return Transform(sign=sign, scale=scale)
    if jnp.issubdtype(jnp.dtype(dtype), jnp.integer):
        scale = size + 1
        # 2**26 keeps every intermediate (prices bounded by
        # vmax_t + bigp + eps0 < 2**28, padded-w sentinels at -2**30)
        # comfortably inside int32 with the implicit-validity masking used
        # by compact.py (pad value = sentinel, w_pad = sentinel - price).
        if vmax_abs * scale >= 2 ** 26:
            raise ValueError(
                f"integer costs too large for the exact int32 path: "
                f"max|cost| * (m+1) = {vmax_abs * scale:.3g} >= 2**26. "
                f"Use float costs (eps-optimal) or reduce the cost range."
            )
        return Transform(sign=sign, scale=scale)
    return Transform(sign=sign, scale=1)


# DEVICE_THETA was chosen for the tiered device paths at 1M on the earlier
# accelerator; not yet measured on the H100.
DEVICE_THETA = 10.0
HOST_THETA = 5.0      # sslap-class reference schedule (CPU GS)


def device_theta_default(n: int) -> float:
    """Size-aware device schedule: theta=10 wins at 1M (fewer expensive
    full-width phase starts) but loses below ~100k, where the aggressive
    eps drops leave the host GS tail re-auctioning long chains at eps_min
    (measured both ways, benchmarks/sweep_schedule.py at 50k and 1M)."""
    return DEVICE_THETA if n >= 200_000 else HOST_THETA


def default_eps_schedule(dtype, vmax_abs: float, size: int, scale: int,
                         eps_min=None, eps_start=None, theta=5,
                         int_exact: bool = False):
    """(eps0, eps_min, theta) defaults. Integer path (int32 or int_exact
    float64): geometric from ~C/2 down to 1 (exact).  Float path: down to
    1/(size+1), floored by the dtype's resolution of the cost range so
    prices keep moving (SURVEY.md SS8.2.3).  ``size`` = effective square
    dimension m (see make_transform)."""
    if theta is None:
        theta = HOST_THETA
    dtype = jnp.dtype(dtype)
    c = float(vmax_abs) * scale
    if int_exact:
        e_min = 1.0 if eps_min is None else float(eps_min)
        e0 = float(eps_start) if eps_start is not None else max(c / 2, e_min)
        return e0, e_min, float(theta)
    if jnp.issubdtype(dtype, jnp.integer):
        e_min = 1 if eps_min is None else int(eps_min)
        e0 = int(eps_start) if eps_start is not None else max(int(c / 2), e_min)
        return e0, e_min, int(theta)
    if eps_min is None:
        res = 1e-12 if dtype == jnp.float64 else 1e-6
        e_min = max(1.0 / (size + 1), c * res)
    else:
        e_min = float(eps_min)
    e0 = float(eps_start) if eps_start is not None else max(c / 2.0, e_min)
    return e0, e_min, float(theta)


def default_max_iter(n: int) -> int:
    # Jacobi rounds, not individual bids; each round retires many rows.
    return min(50 * n + 2000, 10_000_000)


def fr_tighten(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               prices: np.ndarray, iters: int = 2) -> np.ndarray:
    """Forward-reverse dual tightening for warm starts, in place over CSR
    (transformed MAXIMIZATION values; prices same dtype as ``data``).

    Per sweep:  pi_i = max_j (a_ij - p_j)  then
                p_j <- min(p_j, max(0, max_i (a_ij - pi_i))).
    Prices can only FALL -- the direction forward bidding cannot move --
    which repairs pattern-churned warm duals (columns whose supporting
    edges vanished drop to their true market level) while keeping the
    dual information a scalar warm_relax multiply would flatten.  The
    subsequent auction converges from any finite non-negative prices, so
    tightening affects bid counts, never the fixed point.  See the
    fr_tighten docstring in native/sslap_native.cpp for the one-line
    feasibility/monotonicity proofs (Bertsekas forward-reverse family,
    arXiv:1401.0119).

    Native single-pass C++ when the toolchain exists; numpy ufunc.at
    segment-max sweeps otherwise (identical results)."""
    from sslap_tpu.native.build import fr_tighten_native
    if fr_tighten_native(indptr, indices, data, prices, iters):
        return prices
    n = indptr.shape[0] - 1
    m = prices.shape[0]
    dt = prices.dtype
    neg = (np.iinfo(dt).min if np.issubdtype(dt, np.integer)
           else np.array(-np.inf, dt))
    rows_flat = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for _ in range(int(iters)):
        w = data - prices[indices]
        pi = np.full(n, neg, dt)
        np.maximum.at(pi, rows_flat, w)
        # Empty rows keep pi == neg but contribute no flat entries, so the
        # reverse pass never reads them.
        v = data - pi[rows_flat]
        pnew = np.full(m, neg, dt)
        np.maximum.at(pnew, indices, v)
        cand = np.where(pnew == neg, np.array(0, dt),
                        np.maximum(pnew, np.array(0, dt)))
        before = prices.copy()
        np.minimum(prices, cand, out=prices)
        if np.array_equal(before, prices):
            break
    return prices


def validate_warm_prices(warm_prices, m: int) -> np.ndarray:
    """Shape-check a user-supplied warm price vector (one dual per COLUMN);
    a silent mis-shaped array would otherwise surface as an opaque jit
    shape error deep inside the solve."""
    wp = np.asarray(warm_prices)
    if wp.shape != (m,):
        raise ValueError(
            f"warm_prices must have shape ({m},) -- one dual per column -- "
            f"got {wp.shape}")
    return wp
