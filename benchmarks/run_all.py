"""Benchmark harness (T12): the five BASELINE.md configs.

Usage:
    python benchmarks/run_all.py --config 1 [--small]
    python benchmarks/run_all.py --all

Each config prints a JSON line with timing + throughput counters.  Config 5
(10M x 10M multi-host) runs functionally on whatever mesh exists (8-device
virtual CPU mesh here; a real pod slice when available) and reports scaling
diagnostics rather than pod numbers in this single-chip environment.

Speed-of-light calibration (BASELINE.md): --sol measures a pure streaming
pass over the same ELL layout to bound achievable nnz/s.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_sparse(n, m, nnz_per_row, seed=0, integer=False, low=1, high=1000):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row - 1)
    cols = rng.integers(0, m, rows.shape[0], dtype=np.int64)
    perm = rng.permutation(m)[:n].astype(np.int64)
    # Dedup via in-place sort of the fused key (rows/cols recovered by
    # div/mod) -- bit-identical to np.unique(key, return_index=True)
    # followed by rr[idx]/cc[idx] (unique also returns key order) but
    # ~10x faster: no 800 MB argsort-index temp + three gathers.  Was
    # 583 s of the 10M scale config's wall clock (PERF.md round-3).
    key = np.concatenate([rows * m + cols,
                          np.arange(n, dtype=np.int64) * m + perm])
    key.sort()
    keep = np.empty(key.shape[0], bool)
    keep[0] = True
    np.not_equal(key[1:], key[:-1], out=keep[1:])
    key = key[keep]
    rr, cc = key // m, key % m
    if integer:
        vv = rng.integers(low, high, rr.shape[0])
    else:
        vv = (rng.random(rr.shape[0]) * (high - low) + low).astype(np.float32)
    return np.stack([rr, cc], 1), vv


def _timed_solve(loc, val, n, m, **kw):
    from sslap_tpu import auction_solve
    t0 = time.perf_counter()
    res = auction_solve(loc=loc, val=val, shape=(n, m), **kw)
    dt = time.perf_counter() - t0
    return res, dt


def config1(small=False):
    """1k x 1k, 1% density, integer costs; oracle-checked vs scipy."""
    n = m = 1000
    loc, val = make_sparse(n, m, max(int(0.01 * m), 2), seed=1, integer=True)
    res, dt = _timed_solve(loc, val, n, m)          # includes compile
    res2, dt2 = _timed_solve(loc, val, n, m)        # cached
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching
    sp = csr_matrix((val.astype(float), (loc[:, 0], loc[:, 1])), shape=(n, m))
    t0 = time.perf_counter()
    r, c = min_weight_full_bipartite_matching(sp)
    scipy_t = time.perf_counter() - t0
    assert res["meta"]["obj"] == int(sp[r, c].sum()), "objective != optimal"
    return {"config": 1, "n": n, "nnz": len(val), "time": dt2,
            "rounds": res2["meta"]["its"], "scipy_time": scipy_t,
            "speedup_vs_scipy": scipy_t / dt2, "exact": True}


def config2(small=False):
    """10k x 10k sparse with eps-scaling + infeasibility detection path."""
    n = m = 2000 if small else 10_000
    loc, val = make_sparse(n, m, 12, seed=2, integer=True, high=10_000)
    # feasible solve WITH the Hopcroft-Karp pre-check on
    t0 = time.perf_counter()
    from sslap_tpu import auction_solve, InfeasibleError
    res = auction_solve(loc=loc, val=val, shape=(n, m),
                        cardinality_check=True)
    dt = time.perf_counter() - t0
    # Infeasible variant must be detected, not hang: confine rows 0 and 1
    # to the single shared column m-1.
    keep = ~np.isin(loc[:, 0], [0, 1])
    loc_bad = np.concatenate(
        [loc[keep], [[0, m - 1], [1, m - 1]]]).astype(np.int64)
    val_bad = np.concatenate([val[keep], [1, 1]])
    detected = False
    t1 = time.perf_counter()
    try:
        auction_solve(loc=loc_bad, val=val_bad, shape=(n, m),
                      cardinality_check=True)
    except (InfeasibleError, ValueError):
        detected = True
    hk_t = time.perf_counter() - t1
    return {"config": 2, "n": n, "nnz": len(val), "time": dt,
            "rounds": res["meta"]["its"], "hk_detect_time": hk_t,
            "infeasible_detected": detected,
            "soln_found": res["meta"]["soln_found"]}


def config3(small=False):
    """Batched independent LAPs: dense-chunk device hybrid (round 2,
    dense_batch.py) vs the serial native CPU engine on the same batch."""
    from sslap_tpu import ingest
    from sslap_tpu.batch import auction_solve_batched, stack_problems
    from sslap_tpu.hybrid import native_available
    B = 8 if small else 256
    n = m = 256 if small else 4096
    density_nnz = 16 if small else 48
    probs = []
    for b in range(B):
        loc, val = make_sparse(n, m, density_nnz, seed=100 + b)
        probs.append(ingest.from_coo(loc, val, shape=(n, m),
                                     pad_to=density_nnz + 4))
    batched = stack_problems(probs)
    out = {"config": 3, "B": B, "n": n}
    if native_available():
        t0 = time.perf_counter()
        sols_h, metas_h = auction_solve_batched(batched, mode="hybrid")
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        sols_h, metas_h = auction_solve_batched(batched, mode="hybrid")
        dt_h = time.perf_counter() - t0
        # device_time / host_gs_time in dense-hybrid metas are BATCH
        # totals (summed over all chunks) -- name them accordingly
        out.update(hybrid_time=dt_h, hybrid_warm_time=warm,
                   hybrid_instances_per_s=B / dt_h,
                   hybrid_all_found=all(mt["soln_found"] for mt in metas_h),
                   hybrid_device_total_s=metas_h[0]["device_time"],
                   hybrid_gs_total_s=metas_h[0]["host_gs_time"])
        t0 = time.perf_counter()
        sols_c, metas_c = auction_solve_batched(batched, mode="cpu")
        dt_c = time.perf_counter() - t0
        out.update(cpu_time=dt_c, cpu_instances_per_s=B / dt_c,
                   vs_cpu=dt_c / dt_h)
        objs_h = [mt["obj"] for mt in metas_h]
        objs_c = [mt["obj"] for mt in metas_c]
        gaps = [abs(a - b) for a, b in zip(objs_h, objs_c)]
        out["max_obj_gap"] = max(gaps)

    else:
        t0 = time.perf_counter()
        sols, metas = auction_solve_batched(batched)   # includes compile
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        sols, metas = auction_solve_batched(batched)
        dt = time.perf_counter() - t0
        out.update(time=dt, warm_time=warm, instances_per_s=B / dt,
                   all_found=all(mt["soln_found"] for mt in metas))

    # Batch-axis mesh block (VERDICT round-2 task 6): instances are
    # independent, so the mesh story is pure data parallelism with ZERO
    # collectives -- per-chip throughput x D, degraded only by the
    # slowest-lane effect (each device's vmapped while runs to its local
    # max round count).  Measured here on whatever mesh exists (1 chip on
    # this env; the 8-device CPU-sim correctness run lives in
    # tests/test_batch.py::test_batched_sharded_over_mesh), with the lane
    # round-count stats that parameterize the scaling model
    # (PERF.md round 3).
    from sslap_tpu.parallel import make_mesh
    Bm = min(B, 32)
    sub = stack_problems(probs[:Bm])
    mesh = make_mesh(axis_name="batch")
    Dm = mesh.shape["batch"]
    sols_m, metas_m = auction_solve_batched(sub, mesh=mesh,
                                            mode="device")  # warm/compile
    t0 = time.perf_counter()
    sols_m, metas_m = auction_solve_batched(sub, mesh=mesh, mode="device")
    dt_m = time.perf_counter() - t0
    lane_rounds = [mt["its"] for mt in metas_m]
    out["mesh"] = {
        "devices": int(Dm),
        "B": Bm,
        "instances_per_s": Bm / dt_m,
        "per_device_instances_per_s": Bm / dt_m / Dm,
        "all_found": all(mt["soln_found"] for mt in metas_m),
        "lane_rounds_max": int(max(lane_rounds)),
        "lane_rounds_mean": float(np.mean(lane_rounds)),
        # straggler model: D-device wall ~ max over device-local lane
        # maxima; with B/D lanes per device the expected local max shrinks
        # toward the mean as D grows -> scaling efficiency >= mean/max
        "straggler_floor": float(np.mean(lane_rounds) / max(lane_rounds)),
    }
    return out


def config4(small=False):
    """1M x 1M ~10 nnz/row float: primary time-to-optimal measurement
    (bench.py is the canonical runner with the same instance; this runs the
    best 'auto' mode end to end)."""
    from sslap_tpu import AuctionSolver
    n = 50_000 if small else 1_000_000
    loc, val = make_sparse(n, n, 10, seed=0, integer=False)
    # Construct-once solver (bench.py's serving pattern): ingest + device
    # transfer paid once, steady-state solve timed.
    solver = AuctionSolver(loc=loc, val=val, shape=(n, n),
                           cardinality_check=False)
    t0 = time.perf_counter()
    res = solver.solve()                       # warm: compile + transfer
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solver.solve()
    dt = time.perf_counter() - t0
    return {"config": 4, "n": n, "nnz": len(val), "time": dt,
            "warm_time": warm,
            "nnz_per_s": len(val) / dt, "mode": res["meta"].get("mode"),
            "soln_found": res["meta"]["soln_found"]}


def config5(small=False):
    """Row-partitioned multi-device solve on the SHARDED HYBRID path
    (round 3, parallel/sharded_compact.py): per-shard RowPack tiered
    compaction, compact active-set exchanges in narrow tiers (collective
    bytes ~ 3*4*D*C per round, not O(m)), truncated phases, one host GS
    tail.  Unlike the round-2 full-width sharded round (prohibitive for
    one device past ~100k rows), this design is runnable at config-5
    scale: per-round cost tracks the active set on both the compute and
    the wire."""
    import jax
    from sslap_tpu.parallel import auction_solve_sharded_hybrid, make_mesh
    n = m = 20_000 if small else 200_000
    loc, val = make_sparse(n, m, 10, seed=5)
    n_dev = len(jax.devices())
    mesh = make_mesh()
    t0 = time.perf_counter()
    res = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, m),
                                       mesh=mesh, cardinality_check=False)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, m),
                                       mesh=mesh, cardinality_check=False)
    dt = time.perf_counter() - t0
    meta = res["meta"]
    # A/B: depth-1 pipelined full-width rounds (stale bids + acceptance
    # guards).  On the CPU sim mesh the collectives are synchronous so no
    # wall-clock win is expected here; the row documents the functional
    # path + its round-count cost for real ICI/DCN meshes.
    t0 = time.perf_counter()
    res_ov = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, m),
                                          mesh=mesh, overlap=True,
                                          cardinality_check=False)
    dt_ov = time.perf_counter() - t0
    ov = {"time": dt_ov, "rounds": res_ov["meta"]["its"],
          "soln_found": res_ov["meta"]["soln_found"],
          "obj_matches": res_ov["meta"]["obj"] == meta["obj"]}
    # A/B: mesh-balanced ladder buffers (~2C/D + local spill rebuilds) --
    # the multi-card scaling knob; on the sim mesh the row documents
    # round-count/rebuild cost and objective parity.
    t0 = time.perf_counter()
    res_b = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, m),
                                         mesh=mesh, ladder_balance=True,
                                         cardinality_check=False)
    dt_b = time.perf_counter() - t0
    bal = {"time": dt_b, "rounds": res_b["meta"]["its"],
           "ladder_rebuilds": res_b["meta"]["ladder_rebuilds"],
           "comm_bytes_total": res_b["meta"]["comm_bytes_total"],
           "soln_found": res_b["meta"]["soln_found"],
           "obj_matches": res_b["meta"]["obj"] == meta["obj"]}
    return {"config": 5, "n": n, "devices": n_dev, "time": dt,
            "warm_time": warm,
            "overlap_ab": ov,
            "ladder_balance_ab": bal,
            "rounds": meta["its"],
            "host_bids": meta["host_bids"],
            "soln_found": meta["soln_found"],
            "tier_rounds": meta["tier_rounds"],
            "comm_bytes_total": meta["comm_bytes_total"],
            "comm_bytes_fullwidth_equiv": meta["comm_bytes_fullwidth_equiv"],
            "comm_bytes_by_tier": meta["comm_bytes_by_tier"],
            "note": "sharded hybrid (compact exchanges + GS tail); "
                    "pod scaling numbers need >=2 hosts"}


def scale_sharded(small=False):
    """BASELINE config 5 at FULL scale: 10M x 10M through the sharded
    hybrid on every available device (the 8-virtual-device CPU mesh in
    tests; a real slice on hardware).  config5's 200k row validates the
    design; this row validates it AT config-5 size -- 19-tier interleaved
    ladder compile, ~1 GB RowPack per replica set, active-set-
    proportional collectives, GS tail at 10M.

    Oracle: objective vs the native host GS solve of the same instance.
    Float costs, so both are eps_min-optimal rather than identical;
    the gap bound is n * eps_min and the row reports the measured
    relative gap (integer-exact parity is covered by the 1M tests)."""
    import jax
    from sslap_tpu.parallel import auction_solve_sharded_hybrid, make_mesh
    from sslap_tpu import auction_solve
    n = m = 1_000_000 if small else 10_000_000
    t0 = time.perf_counter()
    loc, val = make_sparse(n, m, 10, seed=5)
    t_gen = time.perf_counter() - t0
    mesh = make_mesh()
    t0 = time.perf_counter()
    res = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, m),
                                       mesh=mesh, cardinality_check=False)
    dt = time.perf_counter() - t0
    meta = res["meta"]
    t0 = time.perf_counter()
    host = auction_solve(loc=loc, val=val, shape=(n, m), mode="cpu",
                         cardinality_check=False)
    dt_host = time.perf_counter() - t0
    gap = (abs(meta["obj"] - host["meta"]["obj"])
           / max(abs(host["meta"]["obj"]), 1.0)
           if meta["obj"] is not None and host["meta"]["obj"] is not None
           else None)
    return {"config": "scale_sharded", "n": n,
            "devices": int(mesh.shape["rows"]),
            "gen_s": round(t_gen, 1),
            "time": round(dt, 1),
            "device_time": round(meta["device_time"], 1),
            "host_gs_time": round(meta["host_gs_time"], 1),
            "rounds": meta["its"], "phases": meta["phases"],
            "host_bids": meta["host_bids"],
            "soln_found": meta["soln_found"],
            "tier_rounds": meta["tier_rounds"],
            "comm_bytes_total": meta["comm_bytes_total"],
            "comm_bytes_fullwidth_equiv":
                meta["comm_bytes_fullwidth_equiv"],
            "host_oracle_s": round(dt_host, 1),
            "obj_rel_gap_vs_host": gap}


def sol_calibration(small=False):
    """Speed-of-light: stream the config-4 ELL layout (cols+vals read,
    row-max written) and report achieved bytes/s (BASELINE.md calibration).

    Timing: chained-in-jit two-point fit -- R reps run inside ONE jit with
    a data dependency and the per-rep cost is the slope between two rep
    counts, which cancels dispatch and readback constants."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    n = 100_000 if small else 1_000_000
    K = 16
    rng = np.random.default_rng(0)
    cols = jnp.asarray(rng.integers(0, n, (n, K), dtype=np.int32))
    vals = jnp.asarray(rng.random((n, K), dtype=np.float32))

    def timed(R):
        @jax.jit
        def run(cols, vals):
            def body(i, c):
                # Both arrays are carried and mutated with a data-dependent
                # delta so neither read can be hoisted/CSE'd out of the rep
                # loop (a loop-invariant cols read halves the bytes actually
                # streamed and inflates the reported bound).
                v, cl, acc = c
                a = jnp.max(v, axis=1)
                b = jnp.max(cl, axis=1)
                v = v + a[:, None] * 1e-30
                cl = cl + (b[:, None] & 1)
                return v, cl, acc + a[0] + b[0].astype(jnp.float32)
            _, _, acc = lax.fori_loop(0, R, body,
                                      (vals, cols, jnp.float32(0)))
            return acc
        float(np.asarray(run(cols, vals)))
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            float(np.asarray(run(cols, vals)))
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo, t_hi = timed(40), timed(440)
    dt = max((t_hi - t_lo) / 400, 1e-9)
    # per rep: read + write of both arrays (the writes keep the reads live)
    bytes_moved = n * K * 16
    return {"config": "sol", "bytes_per_s": bytes_moved / dt,
            "nnz_per_s_upper_bound": n * K / dt, "time": dt}


def scale_smoke(small=False, trunc=2048, feasibility_check=True):
    """COMPLETE 10M x 10M solve-to-optimality on ONE chip (round 3,
    VERDICT round-2 task 3; round 2 only ran 60 bounded rounds).

    The pieces that make it finish:
      * native fused packer (compact.np_build_rowpack sign_scale path):
        one C++ pass replaces the 34-61 s numpy pipeline;
      * chunked phase execution: solve_rowpack_tiered(max_phases=1,
        init_state=...) with the TieredState kept DEVICE-resident between
        calls -- each call is one bounded eps phase, so no single
        execution runs for minutes and only scalars are fetched per
        chunk;
      * truncated phases + ONE host GS tail at eps_min (the hybrid
        recipe) for the serial eviction chains;
      * int32-index native Hopcroft-Karp for the feasibility pre-pass
        (VERDICT task 8), reported separately -- off the critical path.

    Optimality certificate: eps_min-CS checked host-side over ALL rows
    (one vectorized pass over the 100M-entry ELL image); with a complete
    assignment this bounds the objective within n * eps_min of optimal.
    """
    import jax
    import jax.numpy as jnp
    from sslap_tpu import ingest as _ingest
    from sslap_tpu import auction as _auction
    from sslap_tpu import compact as _compact
    from sslap_tpu import feasibility as _feas
    from sslap_tpu import hybrid as _hybrid
    n = 1_000_000 if small else 10_000_000
    t0 = time.perf_counter()
    loc, val = make_sparse(n, n, 10, seed=7)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = _ingest.from_coo(loc, val, shape=(n, n))
    t_ing = time.perf_counter() - t0
    t_hk = None
    feasible = None
    if feasibility_check:
        t0 = time.perf_counter()
        feasible = _feas.is_feasible(prob)
        t_hk = time.perf_counter() - t0
    vals_np = np.asarray(prob.vals)
    valid_np = np.asarray(prob.valid)
    tr = _auction.make_transform("min", n, vals_np.dtype, float(val.max()))
    e0, e_min, th = _auction.default_eps_schedule(
        vals_np.dtype, float(val.max()), n, tr.scale,
        theta=_auction.DEVICE_THETA)
    t0 = time.perf_counter()
    rowpack = _compact.np_build_rowpack(
        np.asarray(prob.cols), vals_np, valid_np,
        np.asarray(prob.nvalid), sign_scale=tr.sign * tr.scale)
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    indptr, indices, data_csr = _hybrid.ell_to_csr_transformed(
        prob, tr.sign, tr.scale)
    t_csr = time.perf_counter() - t0
    bigp = float(data_csr.max() - data_csr.min()) + 1.0
    max_iter = _auction.default_max_iter(n)

    # Chunked device pass: one eps phase per call, state device-resident.
    solve_fn = jax.jit(functools.partial(
        _compact.solve_rowpack_tiered, bigp=np.float32(bigp),
        trunc=int(trunc), max_phases=1))
    nvalid_dev = jnp.asarray(np.asarray(prob.nvalid))
    t0 = time.perf_counter()
    state = None
    chunk_times = []
    while True:
        tc = time.perf_counter()
        res, state = solve_fn(rowpack, nvalid_dev,
                              jnp.zeros((n,), jnp.float32),
                              e0, e_min, th, max_iter,
                              init_state=state)
        eps_now = float(np.asarray(res.final_eps))      # scalar fetch
        rounds_now = int(np.asarray(res.rounds))
        chunk_times.append(round(time.perf_counter() - tc, 1))
        print(f"  phase chunk: eps={eps_now:.3g} rounds={rounds_now} "
              f"({chunk_times[-1]}s)", file=sys.stderr, flush=True)
        # compare in the DEVICE dtype: the f32 eps may round a hair above
        # the float64 e_min and must still read as "reached"
        if np.float32(eps_now) <= np.float32(e_min) or \
                rounds_now >= max_iter:
            break
    prices = np.array(res.prices)
    sigma = np.array(res.sigma)
    tier_rounds = np.asarray(state.tier_rounds).tolist()
    t_dev = time.perf_counter() - t0

    # Host GS tail at eps_min finishes the truncated chains.
    t0 = time.perf_counter()
    owner = np.full(n, -1, np.int32)
    assigned = sigma >= 0
    owner[sigma[assigned]] = np.nonzero(assigned)[0].astype(np.int32)
    bids = _hybrid._gs(indptr, indices, data_csr, prices, sigma, owner,
                       e_min, np.float32(bigp), 0, 200 * n + 10_000_000)
    t_gs = time.perf_counter() - t0
    unassigned = int((sigma < 0).sum())

    # Full eps_min-CS certificate (host pass over the ELL image): every
    # row's assigned value within eps_min of its best.  The native fused
    # pass avoids the numpy formulation's five [n, K] temps (~3 GB /
    # 158 s at 10M x 16); the f32 rounding slack is identical in both:
    # prices are reconstructed through 2-3 rounded ops per bid, so CS
    # holds within a few ULPs at the working magnitude (|w| ~ cost_range
    # + prices); without it the cert flags 1-2-ulp wobbles as violations
    # (measured: gaps of ~1.1 ulp at |w|~2000).
    t0 = time.perf_counter()
    from sslap_tpu.native import eps_cs_stats
    stats = eps_cs_stats(np.asarray(prob.cols), vals_np, valid_np,
                         prices, sigma, np.float32(tr.sign * tr.scale)) \
        if eps_cs_stats is not None else None
    if stats is not None:
        v1, cur, a_cur, wmax = stats
        ulp = float(np.spacing(np.float32(wmax)))
    else:
        vals_t = vals_np * np.float32(tr.sign * tr.scale)
        w = np.where(valid_np, vals_t - prices[np.asarray(prob.cols)],
                     np.float32(-np.inf))
        v1 = w.max(axis=1)
        slot = np.argmax(np.asarray(prob.cols) == sigma[:, None],
                         axis=1)[:, None]
        cur = np.take_along_axis(w, slot, axis=1)[:, 0]
        a_cur = np.take_along_axis(vals_np, slot, axis=1)[:, 0]
        finite = np.isfinite(w)
        ulp = float(np.spacing(np.float32(np.abs(w[finite]).max()))) \
            if finite.any() else 0.0
    # Unassigned rows (sigma = -1) would argmax to slot 0 and fake both the
    # certificate and the objective: count only assigned rows (an
    # incomplete solve already reports soln_found=False + unassigned).
    assigned = sigma >= 0
    viol = int(((cur < v1 - np.float32(e_min) - np.float32(8 * ulp))
                & assigned).sum())
    t_cert = time.perf_counter() - t0

    soln_found = unassigned == 0 and bids >= 0
    obj = float(a_cur.sum()) if soln_found else None
    return {"config": "scale", "n": n, "nnz": len(val),
            "soln_found": soln_found,
            "obj": round(obj, 1) if obj is not None else None,
            "eps_cs_violations": viol,
            "gen_s": round(t_gen, 1), "ingest_s": round(t_ing, 1),
            "hk_feasible": feasible, "hk_s": (round(t_hk, 1)
                                              if t_hk else None),
            "pack_s": round(t_pack, 1), "csr_s": round(t_csr, 1),
            "device_s": round(t_dev, 1), "chunk_s": chunk_times,
            "host_gs_s": round(t_gs, 1), "host_gs_bids": int(bids),
            "cert_s": round(t_cert, 1),
            "tier_rounds": tier_rounds,
            "total_s": round(t_gen + t_ing + (t_hk or 0) + t_pack + t_csr
                             + t_dev + t_gs, 1)}


CONFIGS = {"1": config1, "2": config2, "3": config3, "4": config4,
           "5": config5, "sol": sol_calibration, "scale": scale_smoke,
           "scale_sharded": scale_sharded}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=list(CONFIGS), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu-sim", action="store_true",
                    help="pin an 8-virtual-device CPU mesh (the test-suite "
                         "trick) -- for running mesh configs on a box "
                         "without several cards")
    args = ap.parse_args()
    if args.cpu_sim:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    keys = list(CONFIGS) if args.all else [args.config or "1"]
    for k in keys:
        out = CONFIGS[k](small=args.small)
        print(json.dumps(out))


if __name__ == "__main__":
    main()
