"""Comm/compute breakdown for the sharded round (T8 instrumentation).

VERDICT.md round 1 required the scaling measurement harness to be ready
before multi-host hardware exists: this module times the sharded Jacobi
round twice -- with real cross-shard collectives (pmax/pmin of [m] each
round) and with the combine removed -- and reports the difference as
communication cost.  On a >= 2-host mesh this directly yields config 5's
scaling-efficiency number; on the single-chip / CPU-sim meshes available
here it validates the harness and measures the collective overhead of the
mesh it is given.

Timing methodology: R rounds chained inside ONE jit (state carries the
dependency), two-point fit (R1, R2) to cancel dispatch/compile/transfer
constants; a data-dependent scalar is fetched to the host to mark
completion.
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
from sslap_tpu.ingest import ELLProblem
from sslap_tpu.parallel.partition import partition_rows, shard_nnz_counts
from sslap_tpu.parallel.sharded import make_pmax_combine


def _timed_rounds(prob: ELLProblem, vals_t, mesh: Mesh, eps, bigp,
                  axis_name: str, with_comm: bool, reps: int,
                  overlap: bool = False) -> float:
    n_shards = mesh.shape[axis_name]
    n_pad = prob.n
    n_local = n_pad // n_shards
    m = prob.m
    combine = make_pmax_combine(axis_name) if with_comm else None

    def run(cols, vals, valid, nvalid):
        shard = lax.axis_index(axis_name)
        row_offset = shard.astype(jnp.int32) * jnp.int32(n_local)
        prices = jnp.zeros((m,), vals.dtype)
        owner = jnp.full((m,), -1, jnp.int32)
        sigma = jnp.full((n_local,), -1, jnp.int32)
        eps_ = jnp.asarray(eps, vals.dtype)
        bigp_ = jnp.asarray(bigp, vals.dtype)
        row_ids = jnp.int32(row_offset) + jnp.arange(n_local, dtype=jnp.int32)

        if overlap:
            # The overlapped round body (parallel/overlap.py): bid against
            # entry prices, combine the PREVIOUS round's pending bids, then
            # commit with acceptance guards.  The collective is independent
            # of this round's bid compute, so with_comm measures how much of
            # it XLA actually hides behind the arithmetic.
            neg = _auction.neg_sentinel(vals.dtype)

            def body(i, st):
                prices, owner, sigma, pb, pw = st
                tgt, bid = _auction.compute_bids(
                    cols, vals, valid, nvalid, prices, sigma, eps_, bigp_)
                best_l, winner_l = _auction.resolve_bids(tgt, bid, m, row_ids)
                if with_comm:
                    best_g = lax.pmax(pb, axis_name)
                    cand = jnp.where(pb == best_g, pw,
                                     jnp.int32(2 ** 31 - 1))
                    winner_g = lax.pmin(cand, axis_name)
                else:
                    best_g, winner_g = pb, pw
                accept = (winner_g != 2 ** 31 - 1) & (best_g >= prices + eps_)
                prices = jnp.where(accept, best_g, prices)
                owner = jnp.where(accept, winner_g, owner)
                loc = winner_g - jnp.int32(row_offset)
                ok = accept & (loc >= 0) & (loc < n_local)
                sigma = sigma.at[jnp.where(ok, loc, jnp.int32(n_local))].set(
                    jnp.arange(m, dtype=jnp.int32), mode="drop")
                return prices, owner, sigma, best_l, winner_l

            st0 = (prices, owner, sigma,
                   jnp.full((m,), neg, vals.dtype),
                   jnp.full((m,), 2 ** 31 - 1, jnp.int32))
            prices, owner, sigma, _, _ = lax.fori_loop(0, reps, body, st0)
        else:
            def body(i, st):
                prices, owner, sigma = st
                return _auction.jacobi_round(
                    cols, vals, valid, nvalid, prices, owner, sigma,
                    eps_, bigp_, row_offset=row_offset, combine=combine)

            prices, owner, sigma = lax.fori_loop(
                0, reps, body, (prices, owner, sigma))
        out = jnp.sum(prices.ravel()[:4]).astype(jnp.float32)
        return lax.psum(out, axis_name) if with_comm else out

    spec_rows = P(axis_name)
    fn = jax.jit(shard_map(
        run, mesh=mesh,
        in_specs=(spec_rows, spec_rows, spec_rows, spec_rows),
        out_specs=P(),
        check_vma=False,
    ))
    # Process-spanning meshes need explicit placement (the timed output is
    # replicated, so the scalar fetch below works everywhere).
    from sslap_tpu.parallel.mesh import put_global_args
    args = put_global_args(mesh, (spec_rows,) * 4,
                           (prob.cols, vals_t, prob.valid, prob.nvalid))
    float(np.asarray(fn(*args)))          # compile + warm
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        float(np.asarray(fn(*args)))      # fetch forces completion
        best = min(best, time.perf_counter() - t0)
    return best


def measure_round_breakdown(
    prob: ELLProblem,
    mesh: Mesh,
    *,
    problem: str = "min",
    axis_name: str = "rows",
    r1: int = 4,
    r2: int = 12,
    partition: str = "rows",
    overlap: bool = False,
) -> dict:
    """Per-round comm vs compute of the sharded Jacobi round on ``mesh``.

    Returns a dict with per-round seconds: ``round_s`` (with collectives),
    ``compute_s`` (combine removed), ``comm_s`` (difference), the comm
    fraction, and per-shard nnz balance diagnostics.  Multi-host scaling
    efficiency at fixed global size = T(1 host) / T(N hosts) using
    ``round_s`` measured on each mesh.
    """
    vals_np = np.asarray(prob.vals)
    valid_np = np.asarray(prob.valid)
    vmax = float(np.abs(vals_np[valid_np]).max()) if valid_np.any() else 0.0
    tr = _auction.make_transform(problem, prob.m, vals_np.dtype, vmax)
    n_shards = mesh.shape[axis_name]
    part, _ = partition_rows(prob, n_shards, by=partition)
    vals_t = tr.apply(part.vals)
    tvals = vals_np.astype(np.float64) * (tr.sign * tr.scale)
    bigp = (float(tvals[valid_np].max() - tvals[valid_np].min()) + 1.0
            if valid_np.any() else 1.0)
    eps = 1.0

    out = {}
    for name, with_comm in (("round_s", True), ("compute_s", False)):
        t_r1 = _timed_rounds(part, vals_t, mesh, eps, bigp, axis_name,
                             with_comm, r1, overlap=overlap)
        t_r2 = _timed_rounds(part, vals_t, mesh, eps, bigp, axis_name,
                             with_comm, r2, overlap=overlap)
        out[name] = max((t_r2 - t_r1) / (r2 - r1), 1e-9)
    out["comm_s"] = max(out["round_s"] - out["compute_s"], 0.0)
    out["comm_fraction"] = out["comm_s"] / out["round_s"]
    nnz_per_shard = shard_nnz_counts(part, n_shards)
    out["n_shards"] = int(n_shards)
    out["nnz_imbalance"] = float(nnz_per_shard.max() /
                                 max(nnz_per_shard.mean(), 1.0))
    return out
