"""End-to-end smoke run of the solver on one NVIDIA GPU.

    python chip_smoke.py          # every one-card phase
    python chip_smoke.py --four   # the 4-card sharded hybrid and its checks

Each phase prints one JSON object on its own line, with the card's name
and power limit beside its times; the last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

The script exits non-zero, and prints no such line, when JAX finds no GPU
or any phase fails.  It runs in one process, so one process holds each
card.  Results are checked against independent references: scipy for the
exact integer solves, ``mode="cpu"`` (the native Gauss-Seidel engine) for
the 1M float solve, and a plain-numpy eps-complementary-slackness
certificate that shares no code with the solver.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from bench import card_info, make_instance

N_MAIN = 1_000_000          # BASELINE config 4: 1M x 1M, ~10 nnz/row
K_EXTRA = 9
N_INT = 100_000
N_PARITY = 20_000
STEADY_REPS = 3
REL_GAP_MAX = 1e-6


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def eps_cs_violations(rr, cc, vv, sol, prices, eps, sign=-1, scale=1):
    """Plain-numpy eps-CS certificate over every stored entry.

    Transformed values are ``v = sign * scale * cost`` (maximisation) and
    ``prices`` are the solver's transformed-space duals.  A row violates
    eps-CS when ``v[i, sol[i]] - p[sol[i]] < max_j (v[i, j] - p[j]) - eps``.
    The arithmetic is float32, as in the solver; prices are built by a
    few rounded operations per bid, so a slack of 8 ulps at the working
    magnitude is allowed.  Also checks that ``sol`` is a perfect matching
    over stored entries.  Returns the number of violating rows."""
    n = sol.shape[0]
    order = np.argsort(rr, kind="stable")
    rr, cc, vv = rr[order], cc[order], vv[order]
    counts = np.bincount(rr, minlength=n)
    check(bool((counts > 0).all()), "every row has a stored entry")
    check(bool((sol >= 0).all()), "every row is assigned")
    check(np.unique(sol).shape[0] == n, "assignment is injective")
    starts = np.zeros(n, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    prices = np.asarray(prices, np.float32)
    v = (np.asarray(vv, np.float32) * np.float32(sign * scale))
    w = v - prices[cc]
    v1 = np.maximum.reduceat(w, starts)
    mine = cc == sol[rr]
    check(np.bincount(rr[mine], minlength=n).max() == 1
          and int(mine.sum()) == n, "every assigned pair is a stored entry")
    cur = np.empty(n, np.float32)
    cur[rr[mine]] = w[mine]
    ulp = np.spacing(np.float32(np.abs(w).max()))
    slack = np.float32(eps) + np.float32(8) * ulp
    return int((cur < v1 - slack).sum())


def report(card: str) -> dict:
    import jax
    from sslap_tpu.hybrid import native_available
    from sslap_tpu.utils import enable_compile_cache
    cache = enable_compile_cache()
    gpp = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60)
    check(native_available(), "native host engine loaded (hybrid tail)")
    return {"phase": "report", "jax": jax.__version__,
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": cache,
            "native_available": native_available(),
            "gpp": gpp.stdout.splitlines()[0] if gpp.stdout else "",
            "card": card}


def device_paths(card: str, n_dense=256, n_dense_engine=2048, n_batch=512,
                 batch=8, n_infeasible=10_000) -> dict:
    """Small solves that each reach a different device program, exact
    against scipy."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa
    from sslap_tpu import InfeasibleError, auction_solve, ingest
    from sslap_tpu import AuctionSolver
    from sslap_tpu import feasibility_device as fd
    from sslap_tpu.batch import auction_solve_batched, batch_from_dense

    def exact(C):
        r, c = scipy_lsa(C)
        return int(C[r, c].sum())

    out = {"phase": "device_paths", "card": card}
    rng = np.random.default_rng(0)
    C = rng.integers(1, 1000, (n_dense, n_dense))
    for name, kw in (("device", {}),
                     ("device_candidates", {"engine": "candidates"})):
        t0 = time.perf_counter()
        res = auction_solve(C, mode="device", cardinality_check=False, **kw)
        out[name + "_s"] = time.perf_counter() - t0
        check(res["meta"]["soln_found"], f"{name}: solution found")
        check(res["meta"]["obj"] == exact(C), f"{name}: objective == scipy")

    C = rng.integers(1, 1000, (n_dense_engine, n_dense_engine))
    t0 = time.perf_counter()
    res = auction_solve(C, mode="hybrid", engine="dense",
                        cardinality_check=False)
    out["hybrid_dense_s"] = time.perf_counter() - t0
    check(res["meta"].get("engine") == "dense", "dense engine ran")
    check(res["meta"]["obj"] == exact(C), "hybrid dense: objective == scipy")

    mats = rng.integers(1, 1000, (batch, n_batch, n_batch))
    t0 = time.perf_counter()
    sols, metas = auction_solve_batched(batch_from_dense(mats),
                                        mode="device")
    out["batched_device_s"] = time.perf_counter() - t0
    for b in range(batch):
        check(metas[b]["obj"] == exact(mats[b]),
              f"batched instance {b}: objective == scipy")

    mat = np.where(rng.random((2000, 2200)) < 0.004,
                   rng.integers(1, 50, (2000, 2200)), -1).astype(float)
    prob = ingest.from_dense(mat)
    t0 = time.perf_counter()
    mr, mc = fd.greedy_matching(prob)
    out["greedy_matching_s"] = time.perf_counter() - t0
    rows = np.nonzero(mr >= 0)[0]
    check(rows.size > 0, "greedy matching matched rows")
    check(bool((mat[rows, mr[rows]] >= 0).all()), "matched pairs stored")
    check(bool((mc[mr[rows]] == rows).all()), "row/col matching agree")
    check(np.unique(mr[rows]).shape[0] == rows.size, "matching injective")
    out["greedy_matched"] = int(rows.size)

    # Infeasible pattern: rows 0 and 1 can only take column 0.
    n = n_infeasible
    rr, cc, vv = make_instance(n, n, 3, seed=5)
    keep = rr >= 2
    rr = np.concatenate([rr[keep], [0, 1]])
    cc = np.concatenate([cc[keep], [0, 0]])
    vv = np.concatenate([vv[keep], np.float32([1.0, 2.0])])
    solver = AuctionSolver(loc=np.stack([rr, cc], 1), val=vv, shape=(n, n),
                           mode="hybrid")
    try:
        solver.solve()
    except InfeasibleError:
        out["infeasible_raised"] = True
    else:
        raise RuntimeError("check failed: infeasible instance solved")
    return out


def hybrid_int(card: str, n=N_INT) -> dict:
    """Hybrid on an integer sparse instance, exact against scipy."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching
    from sslap_tpu import AuctionSolver
    # Integer costs below 2**26 / (n + 1) keep the exact int32 path.
    rr, cc, vv = make_instance(n, n, K_EXTRA, seed=1, low=1, high=500,
                               integer=True)
    t0 = time.perf_counter()
    res = AuctionSolver(loc=np.stack([rr, cc], 1), val=vv, shape=(n, n),
                        mode="hybrid").solve()
    t_solve = time.perf_counter() - t0
    check(res["meta"]["soln_found"], "hybrid int: solution found")
    sp = csr_matrix((vv.astype(np.float64), (rr, cc)), shape=(n, n))
    r, c = min_weight_full_bipartite_matching(sp)
    ref = int(round(float(sp[r, c].sum())))
    check(res["meta"]["obj"] == ref, "hybrid int: objective == scipy")
    return {"phase": "hybrid_int", "n": n, "nnz": int(rr.shape[0]),
            "obj": res["meta"]["obj"], "scipy_obj": ref,
            "first_solve_s": t_solve, "card": card}


def _timed_solves(solver, reps):
    times, res = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        res = solver.solve()
        times.append(time.perf_counter() - t0)
    return times, res


def hybrid_main(card: str, n=N_MAIN, reps=STEADY_REPS) -> dict:
    """The main path at full size: 1M x 1M float hybrid."""
    import jax
    from sslap_tpu import AuctionSolver
    rr, cc, vv = make_instance(n, n, K_EXTRA, seed=0)
    loc = np.stack([rr, cc], 1)
    t0 = time.perf_counter()
    solver = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="hybrid",
                           cardinality_check=False)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    first = solver.solve()
    t_first = time.perf_counter() - t0
    times, res = _timed_solves(solver, reps)
    meta = res["meta"]
    check(meta["soln_found"], "1M hybrid: solution found")
    check(np.array_equal(first["sol"], res["sol"]),
          "1M hybrid: repeated solves give identical sol")

    t0 = time.perf_counter()
    cpu = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="cpu",
                        cardinality_check=False).solve()
    t_cpu = time.perf_counter() - t0
    check(cpu["meta"]["soln_found"], "1M cpu: solution found")
    rel_gap = abs(meta["obj"] - cpu["meta"]["obj"]) / abs(cpu["meta"]["obj"])
    check(rel_gap < REL_GAP_MAX, f"1M hybrid vs cpu rel gap {rel_gap:.3g}")

    t0 = time.perf_counter()
    viol = eps_cs_violations(rr, cc, vv, res["sol"], res["prices"],
                             meta["final_eps"])
    t_cert = time.perf_counter() - t0
    check(viol == 0, f"1M hybrid: {viol} eps-CS violations")
    stats = jax.devices()[0].memory_stats() or {}
    return {"phase": "hybrid_1m", "n": n, "nnz": int(rr.shape[0]),
            "build_s": t_build, "first_solve_s": t_first,
            "steady_s": times, "steady_median_s": statistics.median(times),
            "device_time": meta["device_time"],
            "readback_time": meta["readback_time"],
            "host_gs_time": meta["host_gs_time"],
            "tier_rounds": meta["tier_rounds"], "its": meta["its"],
            "host_bids": meta["host_bids"], "wide_rounds_auto": bool(
                solver._device_cache.get("wide") is not None),
            "obj": meta["obj"], "cpu_obj": cpu["meta"]["obj"],
            "rel_gap": rel_gap, "cpu_solve_s": t_cpu,
            "eps_min": meta["final_eps"], "eps_cs_violations": viol,
            "cert_s": t_cert,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "card": card}


def widebid_ab(card: str, n=N_MAIN) -> dict:
    """Window-gather phase starts on vs off at 1M, in turns T, F, F, T."""
    from sslap_tpu import AuctionSolver
    rr, cc, vv = make_instance(n, n, K_EXTRA, seed=0)
    loc = np.stack([rr, cc], 1)
    solvers, setup = {}, {}
    for wide in (True, False):
        t0 = time.perf_counter()
        s = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="hybrid",
                          wide_rounds=wide, cardinality_check=False)
        s.solve()                            # compile + layout + transfer
        setup[wide] = time.perf_counter() - t0
        solvers[wide] = s
    times = {True: [], False: []}
    device = {True: [], False: []}
    sols = {}
    for wide in (True, False, False, True):
        t0 = time.perf_counter()
        res = solvers[wide].solve()
        times[wide].append(time.perf_counter() - t0)
        device[wide].append(res["meta"]["device_time"])
        check(res["meta"]["soln_found"], f"wide={wide}: solution found")
        if wide in sols:
            check(np.array_equal(sols[wide], res["sol"]),
                  f"wide={wide}: repeated solves identical")
        sols[wide] = res["sol"]
    check(np.array_equal(sols[True], sols[False]),
          "wide_rounds on/off give bit-identical assignments")
    return {"phase": "widebid_ab", "n": n, "order": "T,F,F,T",
            "setup_s": {"wide": setup[True], "plain": setup[False]},
            "wide_steady_s": times[True], "plain_steady_s": times[False],
            "wide_median_s": statistics.median(times[True]),
            "plain_median_s": statistics.median(times[False]),
            "wide_device_s": device[True], "plain_device_s": device[False],
            "bit_identical": True, "card": card}


def sharded_four(card: str, n=N_MAIN, n_parity=N_PARITY) -> dict:
    """mode='sharded_hybrid' over a 4-card mesh against a one-card hybrid
    of the same instance, plus trunc=0 assignment parity at 20k."""
    import jax
    from sslap_tpu import AuctionSolver, auction_solve
    from sslap_tpu.parallel import auction_solve_sharded_hybrid, make_mesh
    devices = jax.devices()
    check(len(devices) >= 4, f"4 cards visible, found {len(devices)}")
    mesh = make_mesh(devices=devices[:4])
    rr, cc, vv = make_instance(n, n, K_EXTRA, seed=0)
    loc = np.stack([rr, cc], 1)

    t0 = time.perf_counter()
    one = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="hybrid",
                        cardinality_check=False).solve()
    t_one = time.perf_counter() - t0
    check(one["meta"]["soln_found"], "one-card hybrid: solution found")

    times, res = [], None
    for _ in range(2):                       # first call compiles
        t0 = time.perf_counter()
        res = auction_solve_sharded_hybrid(loc=loc, val=vv, shape=(n, n),
                                           mesh=mesh,
                                           cardinality_check=False)
        times.append(time.perf_counter() - t0)
    meta = res["meta"]
    check(meta["soln_found"], "4-card sharded hybrid: solution found")
    rel_gap = abs(meta["obj"] - one["meta"]["obj"]) / abs(one["meta"]["obj"])
    check(rel_gap < REL_GAP_MAX, f"4-card vs one-card rel gap {rel_gap:.3g}")
    viol = eps_cs_violations(rr, cc, vv, res["sol"], res["prices"],
                             meta["final_eps"])
    check(viol == 0, f"4-card: {viol} eps-CS violations")
    mem = [(d.memory_stats() or {}) for d in devices[:4]]

    pr, pc, pv = make_instance(n_parity, n_parity, K_EXTRA, seed=2,
                               low=1, high=1000, integer=True)
    ploc = np.stack([pr, pc], 1)
    single = auction_solve(loc=ploc, val=pv, shape=(n_parity, n_parity),
                           mode="device", cardinality_check=False)
    sh = auction_solve_sharded_hybrid(loc=ploc, val=pv,
                                      shape=(n_parity, n_parity), mesh=mesh,
                                      trunc=0, cardinality_check=False)
    check(sh["meta"]["obj"] == single["meta"]["obj"],
          "trunc=0: objective == single device")
    check(np.array_equal(sh["sol"], single["sol"]),
          "trunc=0: assignment bit-identical to single device")
    return {"phase": "sharded_four", "n": n, "devices": 4,
            "one_card_s": t_one, "sharded_s": times, "obj": meta["obj"],
            "one_card_obj": one["meta"]["obj"], "rel_gap": rel_gap,
            "eps_cs_violations": viol,
            "tier_rounds": meta.get("tier_rounds"),
            "trunc0_n": n_parity, "trunc0_bit_identical": True,
            "memory": [{"device": i,
                        "bytes_in_use": m.get("bytes_in_use"),
                        "peak_bytes_in_use": m.get("peak_bytes_in_use")}
                       for i, m in enumerate(mem)],
            "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded hybrid and its checks")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    card = card_info()
    print(card, flush=True)
    emit(report(card))
    if args.four:
        emit(sharded_four(card))
    else:
        emit(device_paths(card))
        emit(hybrid_int(card))
        emit(hybrid_main(card))
        emit(widebid_ab(card))
    emit({"ok": True, "device": {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": len(devices)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
