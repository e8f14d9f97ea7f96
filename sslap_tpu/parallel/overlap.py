"""Row-sharded auction with comm/compute overlap (T8, BASELINE config 5).

The plain sharded round (parallel/sharded.py) serializes
    bid -> local resolve -> ALL-REDUCE -> commit
so every round stalls on the cross-device combine (NVLink within a host,
the network across hosts).  This module pipelines it one round deep:

    round k body:
      1. BID against the *entry* prices (stale by one commit)   -- compute
      2. COMBINE round k-1's pending (best, winner)             -- collective
      3. COMMIT round k-1's outcome with acceptance guards
      4. carry round k's local (best, winner) as pending

  (1) is independent of (2)/(3), so XLA's latency-hiding scheduler can run
the collective while the bid compute executes -- the collective rides the
wire during the round's arithmetic instead of after it.

Why stale bids stay correct (asynchronous auction, Bertsekas & Castanon):
prices only rise, so a bid computed against old prices overestimates
nothing; on commit we *accept* a column's winning bid only if it still
clears the current price by eps (>= eps progress per accepted bid keeps the
termination argument).  Rejected bidders simply bid again with fresh
prices.  eps-CS holds for accepted winners: their value v2_old - eps was
computed against prices that have only risen since, so every alternative is
now worth at most what it was then.

A row with a bid in flight does not bid again until its outcome commits
(``pending`` mask), which also guarantees a committed winner is still
unassigned -- commits only assign rows that were pending.

All state updates are driven by (combined best/winner, replicated prices),
so price/owner replicas stay bit-identical across shards without extra
collectives.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sslap_tpu import auction as _auction
from sslap_tpu.auction import neg_sentinel

_I32_MAX = 2 ** 31 - 1


def overlapped_phase(
    cols, vals_t, valid, nvalid,      # local row shard [n_local, K]
    prices, owner, sigma,             # prices/owner replicated, sigma local
    eps, bigp,
    row_offset,                       # global id of local row 0
    axis_name: str,
    max_rounds,
):
    """Run one eps phase to completion with 1-deep overlapped combines.
    Returns (prices, owner, sigma, rounds)."""
    n_local, K = cols.shape
    m = prices.shape[0]
    dtype = vals_t.dtype
    neg = neg_sentinel(dtype)
    row_ids = jnp.int32(row_offset) + jnp.arange(n_local, dtype=jnp.int32)

    def count_left(sigma, pending):
        local = jnp.sum(((sigma < 0) & (nvalid > 0)) | pending)
        return lax.psum(local.astype(jnp.int32), axis_name)

    def cond(carry):
        prices, owner, sigma, pending, pb, pw, rounds = carry
        return (count_left(sigma, pending) > 0) & (rounds < max_rounds)

    def body(carry):
        prices, owner, sigma, pending, pb, pw, rounds = carry

        # (1) bids against entry prices; pending rows sit this round out.
        tgt, bid = _auction.compute_bids(
            cols, vals_t, valid, nvalid, prices, sigma, eps, bigp)
        tgt = jnp.where(pending, jnp.int32(m), tgt)
        best_l, winner_l = _auction.resolve_bids(tgt, bid, m, row_ids)

        # (2) combine the PREVIOUS round's pending bids.  Independent of
        # (1), so the all-reduce overlaps the bid compute.
        best_g = lax.pmax(pb, axis_name)
        cand = jnp.where(pb == best_g, pw, jnp.int32(_I32_MAX))
        winner_g = lax.pmin(cand, axis_name)

        # (3) commit with async acceptance guards: the stale bid must still
        # clear the current price by eps.
        accept = (winner_g != _I32_MAX) & (best_g >= prices + eps)
        new_prices = jnp.where(accept, best_g, prices)
        loc = winner_g - jnp.int32(row_offset)
        in_shard = accept & (loc >= 0) & (loc < n_local)
        evict_loc = owner - jnp.int32(row_offset)
        evict_ok = accept & (owner >= 0) & (evict_loc >= 0) & \
            (evict_loc < n_local)
        sigma = sigma.at[jnp.where(evict_ok, evict_loc,
                                   jnp.int32(n_local))].set(-1, mode="drop")
        col_idx = jnp.arange(m, dtype=jnp.int32)
        sigma = sigma.at[jnp.where(in_shard, loc,
                                   jnp.int32(n_local))].set(col_idx,
                                                            mode="drop")
        new_owner = jnp.where(accept, winner_g, owner)

        # Resolve local rows' pending outcomes: a pending row is done
        # whether it won (assigned above) or lost/was rejected (bids again).
        pending = tgt < m          # rows that just bid are pending next

        return (new_prices, new_owner, sigma, pending,
                best_l, winner_l, rounds + 1)

    pending0 = jnp.zeros((n_local,), bool)
    pb0 = jnp.full((m,), neg, dtype)
    pw0 = jnp.full((m,), _I32_MAX, jnp.int32)
    prices, owner, sigma, pending, pb, pw, rounds = lax.while_loop(
        cond, body, (prices, owner, sigma, pending0, pb0, pw0, jnp.int32(0)))
    return prices, owner, sigma, rounds


def solve_ell_overlapped(
    prob_cols, prob_vals_t, prob_valid, prob_nvalid,
    mesh: Mesh,
    p0: jax.Array,
    eps0, eps_min, theta, max_iter, bigp,
    axis_name: str = "rows",
    theta_tail=None,
    tail_phases: int = 2,
) -> _auction.SolveResult:
    """eps-scaled row-sharded solve with overlapped combines.  Square
    effective problems (rows padded to the mesh; no implicit dummies --
    rectangular instances go through parallel/sharded.py)."""
    n_pad, K = prob_cols.shape
    n_shards = mesh.shape[axis_name]
    assert n_pad % n_shards == 0
    m = p0.shape[0]
    dtype = prob_vals_t.dtype
    n_local = n_pad // n_shards

    # numpy (not jnp) closure constants: these are baked into the trace,
    # and eager jnp scalars would be process-local device buffers -- a
    # placement error on a process-spanning mesh.
    np_dtype = np.dtype(dtype)
    eps0_ = np.maximum(np.asarray(eps0, np_dtype),
                       np.asarray(eps_min, np_dtype))
    eps_min_ = np.asarray(eps_min, np_dtype)
    theta_ = np.asarray(theta, np_dtype)
    theta_tail_ = (None if theta_tail is None
                   else np.asarray(theta_tail, np_dtype))
    max_iter_ = np.asarray(max_iter, np.int32)
    bigp_ = np.asarray(bigp, np_dtype)

    def run(cols, vals_t, valid, nvalid, p0_rep):
        shard = lax.axis_index(axis_name)
        row_offset = shard.astype(jnp.int32) * jnp.int32(n_local)

        def phase(carry):
            prices, owner, sigma, eps, rounds, phases = carry
            prices, owner, sigma, r = overlapped_phase(
                cols, vals_t, valid, nvalid, prices, owner, sigma,
                eps, bigp_, row_offset, axis_name,
                max_iter_ - rounds)
            return prices, owner, sigma, eps, rounds + r, phases + 1

        def outer_cond(carry):
            st, done = carry
            return jnp.logical_not(done)

        def outer_body(carry):
            (prices, owner, sigma, eps, rounds, phases), _ = carry
            prices, owner, sigma, eps, rounds, phases = phase(
                (prices, owner, sigma, eps, rounds, phases))
            done = (eps <= eps_min_) | (rounds >= max_iter_)
            eps = jnp.where(done, eps,
                            _auction._next_eps(eps, theta_, eps_min_,
                                               theta_tail=theta_tail_,
                                               tail_phases=tail_phases))
            if True:  # warm start: unassign only eps-CS violators
                def advance(args):
                    prices, owner, sigma, eps = args
                    return _auction.unassign_violators(
                        cols, vals_t, valid, prices, owner, sigma, eps,
                        n_dummy=0,
                        combine_owner=lambda o: lax.pmin(o, axis_name))
                owner, sigma = lax.cond(
                    done, lambda a: (a[1], a[2]),
                    lambda a: advance((a[0], a[1], a[2], a[3])),
                    (prices, owner, sigma, eps))
            return ((prices, owner, sigma, eps, rounds, phases), done)

        init = (p0_rep.astype(dtype),
                jnp.full((m,), -1, jnp.int32),
                jnp.full((n_local,), -1, jnp.int32),
                eps0_, jnp.int32(0), jnp.int32(0))
        (prices, owner, sigma, eps, rounds, phases), _ = lax.while_loop(
            outer_cond, outer_body, (init, jnp.bool_(False)))

        unassigned = lax.psum(
            jnp.sum((sigma < 0) & (nvalid > 0)).astype(jnp.int32), axis_name)
        return _auction.SolveResult(
            sigma=sigma, prices=prices, rounds=rounds, phases=phases,
            final_eps=eps, unassigned=unassigned)

    spec_rows = P(axis_name)
    spec_rep = P()
    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(spec_rows, spec_rows, spec_rows, spec_rows, spec_rep),
        out_specs=_auction.SolveResult(
            sigma=spec_rows, prices=spec_rep, rounds=spec_rep,
            phases=spec_rep, final_eps=spec_rep, unassigned=spec_rep),
        check_vma=False,
    )
    from sslap_tpu.parallel.mesh import put_global_args
    args = put_global_args(
        mesh, (spec_rows, spec_rows, spec_rows, spec_rows, spec_rep),
        (prob_cols, prob_vals_t, prob_valid, prob_nvalid, p0))
    return jax.jit(fn)(*args)


def auction_solve_overlapped(
    mat=None,
    *,
    loc=None,
    val=None,
    shape=None,
    problem: str = "min",
    mesh: Optional[Mesh] = None,
    eps_start=None,
    eps_min=None,
    theta: Optional[float] = None,
    theta_tail: Optional[float] = None,
    tail_phases: int = 2,
    max_iter: Optional[int] = None,
    cardinality_check: bool = True,
    dtype=None,
    axis_name: str = "rows",
    instrument: bool = False,
    warm_prices=None,
):
    """auction_solve with the overlapped row-sharded backend.  Same result
    contract as api.auction_solve; square problems only.

    ``instrument=True`` measures the per-round comm/compute split of the
    OVERLAPPED round body on this mesh (parallel/scaling.py harness with
    overlap=True: the collective combines the previous round's pending
    bids while the current round's bid compute runs) and attaches
    ``round_s``/``compute_s``/``comm_s``/``comm_fraction`` to the meta."""
    from sslap_tpu import api as _api
    from sslap_tpu import feasibility as _feas
    from sslap_tpu.parallel.mesh import make_mesh
    from sslap_tpu.parallel.partition import pad_rows_for_mesh

    t0 = time.perf_counter()
    prob = _api._ingest_any(mat=mat, loc=loc, val=val, shape=shape,
                            dtype=dtype)
    if prob.n != prob.m:
        raise ValueError("overlapped backend requires a square problem; "
                         "use parallel.auction_solve_sharded for n < m")
    if np.asarray(prob.vals).dtype == np.float64:
        # Includes int_exact: a silent f32 downcast on device would
        # corrupt costs above 2**24 (see sharded.py).
        raise ValueError("float64 costs ride the host CPU path "
                         "(mode='cpu'); the overlapped backend is "
                         "f32/int32")
    if cardinality_check and not _feas.is_feasible(prob):
        raise _api.InfeasibleError(
            "no perfect matching exists for this sparsity pattern")
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)

    vals_np = np.asarray(prob.vals)
    valid_np = np.asarray(prob.valid)
    vmax_abs = float(np.abs(vals_np[valid_np]).max()) if valid_np.any() else 0.0
    tr = _auction.make_transform(problem, prob.m, vals_np.dtype, vmax_abs)
    theta_eff = (_auction.device_theta_default(prob.n)
                 if theta is None else theta)
    if theta_tail is None:
        # Mixed tail default, matching the single-chip hybrid (PERF.md
        # round-3 theta A/B; VERDICT r3 missing #2).
        theta_tail = 3.0 if float(theta_eff) > 5 else 0.0
    if tail_phases < 1:
        raise ValueError("tail_phases must be >= 1")
    e0, e_min, theta_v = _auction.default_eps_schedule(
        vals_np.dtype, vmax_abs, prob.m, tr.scale,
        eps_min=eps_min, eps_start=eps_start,
        theta=theta_eff)
    if max_iter is None:
        max_iter = _auction.default_max_iter(prob.n)

    tvals = vals_np.astype(np.int64) if np.issubdtype(
        vals_np.dtype, np.integer) else vals_np.astype(np.float64)
    tvals = tvals * (tr.sign * tr.scale)
    bigp = (float(tvals[valid_np].max() - tvals[valid_np].min()) + 1.0
            if valid_np.any() else 1.0)

    n_real = prob.n
    prob_p = pad_rows_for_mesh(prob, mesh.shape[axis_name])
    vals_t = np.asarray(prob_p.vals) * np.asarray(
        tr.sign * tr.scale, vals_np.dtype)
    p0 = (jnp.zeros((prob.m,), vals_np.dtype) if warm_prices is None
          else jnp.asarray(_auction.validate_warm_prices(warm_prices,
                                                         prob.m),
                           vals_np.dtype))

    res = solve_ell_overlapped(
        jnp.asarray(prob_p.cols), jnp.asarray(vals_t),
        jnp.asarray(prob_p.valid), jnp.asarray(prob_p.nvalid),
        mesh, p0, e0, e_min, theta_v, max_iter, bigp, axis_name=axis_name,
        theta_tail=theta_tail, tail_phases=tail_phases)
    from sslap_tpu.parallel.mesh import fetch_global
    sol = fetch_global(res.sigma)[:n_real]
    t1 = time.perf_counter()
    n_empty = int((np.asarray(prob.nvalid) == 0).sum())
    unassigned = int(np.asarray(res.unassigned)) + n_empty
    soln_found = unassigned == 0
    meta = {
        "obj": _api._objective_host(prob, sol) if soln_found else None,
        "its": int(np.asarray(res.rounds)),
        "phases": int(np.asarray(res.phases)),
        "soln_found": soln_found,
        "final_eps": float(np.asarray(res.final_eps)) / tr.scale,
        "unassigned": unassigned,
        "time": t1 - t0,
        "n_shards": int(mesh.shape[axis_name]),
        "mode": "overlapped",
        "overlap": True,
    }
    if instrument:
        from sslap_tpu.parallel.scaling import measure_round_breakdown
        meta.update(measure_round_breakdown(
            prob, mesh, problem=problem, axis_name=axis_name,
            overlap=True))
    return _api.AuctionSolution(sol=sol, meta=meta,
                                prices=np.asarray(res.prices))
