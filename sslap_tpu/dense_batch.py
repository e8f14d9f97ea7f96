"""Dense-chunk batched hybrid engine (T9 device path; BASELINE config 3).

Why dense: for batched small-m instances (256x independent 4k x 4k at ~1%
density), a full-width sparse bid round costs one random price gather per
stored entry, while the dense round streams the contiguous [n, m] block
at memory speed and sidesteps the row-side segment-reduce join (the
per-row top-2 is a contiguous reduce).  Only sensible when an instance's
dense block fits on the device (m <= ~16k); the 1M-column single-instance
path keeps the compacted ELL design (compact.py).

On the earlier accelerator the serial native CPU engine won config 3 --
at n = 4096 the price table is L1-resident and a CPU bid is cheap.
`auto` therefore routes batches to the CPU when the toolchain exists;
this engine is the device-first path (no toolchain, busy host cores) and
the shape to shard over a batch-axis mesh.  Not yet measured on the
H100.

Flow per chunk of instances (one jit execution, vmapped over the chunk):
  scatter ELL -> dense w-base once; then eps phases of full-width dense
  Jacobi rounds, each phase truncated once every lane's active set is
  <= ``trunc`` (only the final eps_min phase must complete -- hybrid.py's
  truncation argument); per-phase eps-CS violator rescan (warm starts).
Host: one native Gauss-Seidel tail per instance at eps_min finishes the
serial eviction chains (identical bid semantics; eps-CS preserved).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from sslap_tpu import auction as _auction
from sslap_tpu.auction import neg_sentinel
from sslap_tpu.ingest import ELLProblem


def _dense_from_ell(cols, vals_t, valid, m: int):
    """[n, K] ELL -> [n, m] dense maximization values; missing entries get
    the neg sentinel.  Scatter-max is deterministic under the duplicate
    padding entries (their value IS the sentinel, never winning)."""
    n, K = cols.shape
    dtype = vals_t.dtype
    neg = neg_sentinel(dtype)
    rows = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, K))
    upd = jnp.where(valid, vals_t, neg)
    return jnp.full((n, m), neg, dtype).at[rows, cols].max(upd, mode="drop")


def _dense_bids(A, nvalid, prices, sigma, eps, bigp):
    """Full-width dense top-2 bid (same semantics as auction.compute_bids:
    lowest-column argmax tie-break, v2 = v1 - bigp single-entry rule)."""
    n, m = A.shape
    dtype = A.dtype
    neg = neg_sentinel(dtype)
    w = A - prices[None, :]
    jstar = jnp.argmax(w, axis=1).astype(jnp.int32)     # first max
    v1 = jnp.take_along_axis(w, jstar[:, None], axis=1)[:, 0]
    col_iota = jnp.arange(m, dtype=jnp.int32)
    v2 = jnp.max(jnp.where(col_iota[None, :] == jstar[:, None], neg, w),
                 axis=1)
    v2 = jnp.where(nvalid >= 2, v2, v1 - bigp)
    a_star = v1 + prices[jstar]
    bid = a_star - v2 + eps
    bidding = (sigma < 0) & (nvalid > 0)
    tgt = jnp.where(bidding, jstar, jnp.int32(m))
    return tgt, bid


def _dense_unassign_violators(A, prices, owner, sigma, eps):
    """Phase-start warm start: free rows whose assigned pair violates
    eps-CS at the (new) eps (dense mirror of auction.unassign_violators)."""
    n, m = A.shape
    w = A - prices[None, :]
    v1 = jnp.max(w, axis=1)
    safe_sig = jnp.where(sigma >= 0, sigma, 0)
    cur = jnp.take_along_axis(w, safe_sig[:, None].astype(jnp.int32),
                              axis=1)[:, 0]
    viol = (sigma >= 0) & (cur < v1 - eps)
    owner = owner.at[jnp.where(viol, sigma, m)].set(-1, mode="drop")
    sigma = jnp.where(viol, -1, sigma)
    return owner, sigma


def _solve_chunk(cols, vals_t, valid, nvalid,
                 eps0, eps_min, theta, max_iter, bigp, trunc):
    """All eps phases for one instance, dense rounds, phase truncation.
    vmapped over the chunk axis by the caller; while_loop conditions batch
    to 'any lane still above trunc' under vmap."""
    n, K = cols.shape
    m = n  # square (config-3 domain); rectangular falls back upstream
    dtype = vals_t.dtype
    A = _dense_from_ell(cols, vals_t, valid, m)
    row_ids = jnp.arange(n, dtype=jnp.int32)

    def active(sigma):
        return jnp.sum((sigma < 0) & (nvalid > 0)).astype(jnp.int32)

    def phase(carry):
        prices, owner, sigma, eps, rounds, phases = carry

        def cond(st):
            prices, owner, sigma, rounds = st
            return (active(sigma) > trunc) & (rounds < max_iter)

        def body(st):
            prices, owner, sigma, rounds = st
            tgt, bid = _dense_bids(A, nvalid, prices, sigma, eps, bigp)
            best, winner = _auction.resolve_bids(tgt, bid, m, row_ids)
            prices, owner, sigma = _auction.commit_bids(
                best, winner, prices, owner, sigma, 0)
            return prices, owner, sigma, rounds + 1

        prices, owner, sigma, rounds = lax.while_loop(
            cond, body, (prices, owner, sigma, rounds))
        return prices, owner, sigma, eps, rounds, phases + 1

    prices = jnp.zeros((m,), dtype)
    owner = jnp.full((m,), -1, jnp.int32)
    sigma = jnp.full((n,), -1, jnp.int32)
    eps = jnp.maximum(jnp.asarray(eps0, dtype), jnp.asarray(eps_min, dtype))
    carry = phase((prices, owner, sigma, eps, jnp.int32(0), jnp.int32(0)))

    def outer_cond(c):
        _, _, _, eps, rounds, _ = c
        return (eps > eps_min) & (rounds < max_iter)

    def outer_body(c):
        prices, owner, sigma, eps, rounds, phases = c
        eps = _auction._next_eps(eps, jnp.asarray(theta, dtype),
                                 jnp.asarray(eps_min, dtype))
        owner, sigma = _dense_unassign_violators(A, prices, owner, sigma,
                                                 eps)
        return phase((prices, owner, sigma, eps, rounds, phases))

    prices, owner, sigma, eps, rounds, phases = lax.while_loop(
        outer_cond, outer_body, carry)
    return prices, sigma, rounds, phases, eps


import functools


@functools.partial(jax.jit, static_argnames=())
def _solve_chunk_vmapped(cols, vals_t, valid, nvalid,
                         eps0, eps_min, theta, max_iter, bigp, trunc):
    return jax.vmap(
        _solve_chunk,
        in_axes=(0, 0, 0, 0, None, None, None, None, None, None),
    )(cols, vals_t, valid, nvalid, eps0, eps_min, theta, max_iter, bigp,
      trunc)


def dense_hybrid_available(prob: ELLProblem) -> bool:
    # The n <= 16384 limit was chosen on the earlier accelerator; not yet
    # measured on the H100.
    from sslap_tpu import hybrid as _hybrid
    return (_hybrid.native_available()
            and prob.n == prob.m
            and prob.n <= 16384
            and not prob.int_exact
            and np.dtype(np.asarray(prob.vals).dtype) != np.float64)


def solve_batched_dense_hybrid(
    prob: ELLProblem,
    *,
    problem: str = "min",
    eps_start=None,
    eps_min=None,
    theta: float = 5.0,
    max_iter: Optional[int] = None,
    trunc: int = 128,
    chunk: Optional[int] = None,
    dense_budget_bytes: int = 2 << 30,
    return_prices: bool = False,
    device_cache: Optional[dict] = None,
):
    """Batched square instances via dense device chunks + native GS tails.

    Returns (sols [B, n] numpy int32, metas list) with the same meta
    contract as batch.auction_solve_batched; with ``return_prices=True``
    additionally returns the final transformed-domain price vectors
    [B, m] (third tuple element) -- the single-instance ``engine='dense'``
    API path exposes them on the AuctionSolution like every other mode.

    ``device_cache``: an AuctionSolver-owned dict; when the batch fits one
    chunk, the device-resident ELL arrays and the host CSR are cached
    across calls (construct-once serving parity with the RowPack hybrid:
    a re-solve does not re-ship the dense-engine inputs).
    """
    from sslap_tpu import hybrid as _hybrid
    assert prob.cols.ndim == 3, "expected batched ELLProblem"
    B, n, K = prob.cols.shape
    m = prob.m
    assert n == m, "dense batched engine is square-only"
    t0 = time.perf_counter()

    vals_np = np.asarray(prob.vals)
    valid_np = np.asarray(prob.valid)
    dtype = vals_np.dtype
    # Value-range scalars: computed with ONE O(nnz) masked extraction and
    # cached across serving re-solves (round 5: the previous per-call
    # float64 [B, n, K] ``tvals`` temporary alone was ~1 GB of host
    # traffic per cached dense-4096 solve on the 1-vCPU host).  Same
    # caller contract as every other field in this cache: one solver, one
    # problem; same-shape different data must not reuse the dict.
    skey = ("dense_scalars", B, n, K, str(dtype), prob.nnz, problem)
    if device_cache is not None and device_cache.get("dense_skey") == skey:
        vmax_abs, vmin_v, vmax_v = device_cache["dense_scalars"]
    else:
        if valid_np.any():
            vv = vals_np[valid_np]
            vmax_abs = float(np.abs(vv).max())
            vmin_v = float(vv.min())
            vmax_v = float(vv.max())
            del vv
        else:
            vmax_abs = vmin_v = vmax_v = 0.0
        if device_cache is not None:
            device_cache.update(dense_skey=skey,
                                dense_scalars=(vmax_abs, vmin_v, vmax_v))
    tr = _auction.make_transform(problem, m, dtype, vmax_abs,
                                 int_exact=prob.int_exact)
    e0, e_min, theta_v = _auction.default_eps_schedule(
        dtype, vmax_abs, m, tr.scale,
        eps_min=eps_min, eps_start=eps_start, theta=theta,
        int_exact=prob.int_exact)
    if max_iter is None:
        max_iter = _auction.default_max_iter(n)

    # chunk size: dense [chunk, n, m] within the device budget
    itemsize = np.dtype(dtype).itemsize
    if chunk is None:
        chunk = max(1, min(B, dense_budget_bytes // (n * m * itemsize)))

    # bigp = transformed-value spread + 1; the transform is linear, so the
    # spread is |sign*scale| * (max - min) of the raw values -- no
    # full-size transformed temporary needed.
    bigp = (abs(float(tr.sign * tr.scale)) * (vmax_v - vmin_v) + 1.0
            if valid_np.any() else 1.0)

    cache_key = (B, n, K, str(dtype), tr.sign, tr.scale, prob.nnz)
    cols_all = np.asarray(prob.cols)
    vals_all = np.asarray(prob.vals)
    if device_cache is not None and \
            device_cache.get("dense_key") == cache_key:
        (nvalid_all, counts, indptr_all, indices_flat, data_flat,
         inst_off, obj_keys, obj_vals) = device_cache["dense_csr"]
    else:
        # Batched host CSR in ONE pass over the whole batch (the
        # per-instance mask-and-extract loop measured ~40 s at B=256,
        # n=4096 -- more than the device pass itself).
        nvalid_all = np.asarray(prob.nvalid)
        counts = valid_np.sum(axis=2).astype(np.int64)      # [B, n]
        indptr_all = np.zeros((B, n + 1), np.int64)
        np.cumsum(counts, axis=1, out=indptr_all[:, 1:])
        indices_flat = cols_all[valid_np].astype(np.int32)  # batch-major
        data_flat = (vals_all[valid_np] *
                     np.asarray(tr.sign * tr.scale, dtype)).astype(dtype)
        inst_off = np.zeros(B + 1, np.int64)
        np.cumsum(counts.sum(axis=1), out=inst_off[1:])
        # Objective lookup table (round 5): global (b*n + r)*m + c keys
        # over the RAW values.  When every row's columns are ascending
        # (ingest's ELL order) the keys are globally sorted, and the
        # per-solve exact objective becomes one O(n log nnz) searchsorted
        # gather instead of three [B, n, K] broadcast temporaries (~1.5 GB
        # of host traffic per cached dense-4096 solve).
        rows_flat = np.repeat(np.arange(B * n, dtype=np.int64),
                              counts.ravel())
        obj_keys = rows_flat * m + indices_flat
        obj_keys = obj_keys if obj_keys.size == 0 or \
            bool((np.diff(obj_keys) > 0).all()) else None
        obj_vals = (vals_all[valid_np].astype(np.float64)
                    if obj_keys is not None else None)
        del rows_flat
        if device_cache is not None:
            device_cache.update(
                dense_key=cache_key,
                dense_csr=(nvalid_all, counts, indptr_all, indices_flat,
                           data_flat, inst_off, obj_keys, obj_vals))

    sols = np.full((B, n), -1, np.int32)
    prices_out = np.zeros((B, m), dtype) if return_prices else None
    metas = []
    dev_s = 0.0
    gs_s = 0.0

    def take(a, lo, hi):
        """Slice [lo:hi], padding a short final chunk by repeating the
        last instance so every chunk reuses ONE compiled shape (padded
        lanes' results are discarded)."""
        part = np.asarray(a[lo:hi])
        if hi - lo < chunk:
            reps = np.repeat(part[-1:], chunk - (hi - lo), axis=0)
            part = np.concatenate([part, reps], axis=0)
        return part

    # Dispatch EVERY chunk up front: jax dispatch is async, so the device
    # pipelines chunk k+1 while the host runs chunk k's GS tails.
    td0 = time.perf_counter()
    pending = []
    cache_chunks = device_cache is not None and chunk >= B
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        ckey = ("dense_dev", cache_key, lo, hi)
        if cache_chunks and device_cache.get("dense_dev_key") == ckey:
            c_d, v_d, vd_d, nv_d = device_cache["dense_dev"]
        else:
            c_d = jnp.asarray(take(prob.cols, lo, hi))
            v_d = tr.apply(take(prob.vals, lo, hi))
            vd_d = jnp.asarray(take(valid_np, lo, hi))
            nv_d = jnp.asarray(take(nvalid_all, lo, hi))
            if cache_chunks:
                device_cache.update(dense_dev_key=ckey,
                                    dense_dev=(c_d, v_d, vd_d, nv_d))
        outs = _solve_chunk_vmapped(
            c_d, v_d, vd_d, nv_d,
            jnp.asarray(e0, dtype), jnp.asarray(e_min, dtype),
            jnp.asarray(theta_v, dtype), jnp.int32(max_iter),
            jnp.asarray(bigp, dtype), jnp.int32(trunc))
        pending.append((lo, hi, outs))
    dispatch_s = time.perf_counter() - td0

    e_min_h = np.asarray(e_min, dtype)
    bigp_h = np.asarray(bigp, dtype)
    for lo, hi, (prices_d, sigma_d, rounds_d, phases_d, eps_d) in pending:
        td0 = time.perf_counter()
        prices_h = np.array(prices_d)       # blocks on THIS chunk only
        sigma_h = np.array(sigma_d)
        rounds_h = np.array(rounds_d)
        phases_h = np.array(phases_d)
        eps_h = np.array(eps_d)
        dev_s += time.perf_counter() - td0

        tg0 = time.perf_counter()
        for b in range(lo, hi):
            i = b - lo
            indptr = indptr_all[b]
            sl = slice(inst_off[b], inst_off[b + 1])
            prices_b = prices_h[i].copy()
            sigma_b = sigma_h[i].copy()
            owner_b = np.full(m, -1, np.int32)
            assigned = sigma_b >= 0
            owner_b[sigma_b[assigned]] = \
                np.nonzero(assigned)[0].astype(np.int32)
            bids = _hybrid._gs(indptr, indices_flat[sl], data_flat[sl],
                               prices_b, sigma_b, owner_b, e_min_h, bigp_h,
                               0, _hybrid.tail_bid_budget(n))
            unassigned = int(((sigma_b < 0) & (counts[b] > 0)).sum())
            unassigned += int((nvalid_all[b] == 0).sum())
            # Like hybrid._finish_square_fast_path: a lane that exited on
            # max_iter at eps > eps_min is NOT eps_min-optimal even if the
            # GS tail completed the assignment.
            eps_reached = bool(eps_h[i] <= e_min_h)
            soln_found = unassigned == 0 and bids >= 0 and eps_reached
            sols[b] = sigma_b
            if return_prices:
                prices_out[b] = prices_b
            metas.append({
                "obj": None,
                "its": int(rounds_h[i]),
                "phases": int(phases_h[i]),
                "host_bids": max(int(bids), 0),
                "soln_found": soln_found,
                "final_eps": (float(e_min) if eps_reached
                              else float(eps_h[i])) / tr.scale,
                "unassigned": unassigned,
                "mode": "dense-hybrid",
            })
        gs_s += time.perf_counter() - tg0

    # Batched exact objectives (host).  Fast path: binary-search each
    # assigned (row, col) pair in the sorted key table -- O(n log nnz) --
    # falling back to the one-shot [B, n, K] broadcast pass when the ELL
    # column order wasn't ascending (obj_keys is None).
    if obj_keys is not None:
        sig_flat = sols.ravel().astype(np.int64)
        rows_glob = np.arange(B * n, dtype=np.int64)
        matched = sig_flat >= 0
        q = rows_glob[matched] * m + sig_flat[matched]
        pos = np.searchsorted(obj_keys, q)
        pos_c = np.minimum(pos, max(obj_keys.size - 1, 0))
        ok = (pos < obj_keys.size) & (obj_keys[pos_c] == q)
        contrib = np.where(ok, obj_vals[pos_c], 0.0)
        acc = np.bincount(rows_glob[matched] // n, weights=contrib,
                          minlength=B)
    else:
        hit = (cols_all == sols[:, :, None]) & valid_np      # [B, n, K]
        acc = np.where(hit, vals_all, 0).astype(np.float64).sum(axis=(1, 2))
    integral = np.issubdtype(vals_all.dtype, np.integer) or prob.int_exact
    for b, mt in enumerate(metas):
        if mt["soln_found"]:
            mt["obj"] = int(round(acc[b])) if integral else float(acc[b])
    total = time.perf_counter() - t0
    for mt in metas:
        mt["time"] = total
        mt["device_time"] = dev_s + dispatch_s
        mt["host_gs_time"] = gs_s
    if return_prices:
        return sols, metas, prices_out
    return sols, metas
