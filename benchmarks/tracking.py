"""End-to-end tracking-workload benchmark (VERDICT r3 task 8).

The motivating workload for warm starts: a persistent assignment problem
re-solved frame after frame as costs drift (object tracking, sensor
fusion).  This harness composes the package's three warm paths the way
that workload would:

  - ``warm_prices``    previous frame's dual prices seed the auction
  - ``hopcroft_solve(warm=)``  previous matching seeds the feasibility
                       re-check when the sparsity pattern changed
  - construct-once     ``AuctionSolver`` device caches (pattern-stable
                       frames skip re-ingest and H2D entirely)

Three drift families over a 1M x 1M / 10 nnz/row instance
(--families ABC):

  values : costs drift (clipped Gaussian), sparsity pattern FIXED.
           Warm frames skip feasibility (pattern unchanged) and re-solve
           from the previous duals with a DRIFT-MATCHED schedule
           (eps_start ~ 4x the drift sigma): the auction's residual work
           after a warm start scales with (price error / eps), so
           restarting at eps ~ drift and descending gives 2-3 cheap
           phases, where eps_start=0 (a single eps_min phase) measured
           a blown bid budget -- the price error is ~10^4 eps_min.
           Exactness is unchanged (the final phase still completes at
           eps_min).
  pattern: 0.1% of non-anchor edges replaced per frame (plus value
           drift; the previous frame's MATCHING is protected -- real
           trackers' current tracks persist).  Warm frames re-ingest,
           warm-HK from the previous matching, and warm-start prices
           (--warm fr: FR-tightened duals + drift-matched eps_start).
  persistent (C): pattern FIXED, tiny drift (sigma <= 0.1% of the cost
           range) over >= 4 chained warm frames -- the classic
           persistent-detection tracking regime.

Cold frames solve from scratch (fresh solver, full HK, full eps
schedule).  Output: one JSON line per frame + a frames/s summary.

Usage: python benchmarks/tracking.py [--n 1000000] [--frames 3]
                                     [--mode hybrid|cpu|auto]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sslap_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def drift_values(val, rng, sigma=10.0, low=1.0, high=1000.0):
    return np.clip(val + rng.standard_normal(val.shape).astype(np.float32)
                   * np.float32(sigma), low, high).astype(np.float32)


def drift_pattern(rr, cc, vv, n, m, n_anchor, rng, frac=1e-3,
                  low=1.0, high=1000.0, protect_keys=None):
    """Replace ``frac`` of the non-anchor edges with fresh random ones.
    The first ``n_anchor`` edges (a permutation) stay put so every frame
    remains feasible -- the tracking analogue of persistent detections.
    ``protect_keys`` (sorted int64 r*m+c keys, e.g. the previous frame's
    MATCHING) are likewise exempt from churn: a real tracker's current
    tracks persist into the next frame, and without this the churn can
    destroy feasibility outright (observed at 1M/4 frames, round 5)."""
    e = rr.shape[0]
    repl = rng.random(e) < frac
    repl[:n_anchor] = False
    if protect_keys is not None and len(protect_keys):
        repl &= ~np.isin(rr * np.int64(m) + cc, protect_keys)
    k = int(repl.sum())
    rr = rr.copy()
    cc = cc.copy()
    vv = vv.copy()
    rr[repl] = rng.integers(0, n, k)
    cc[repl] = rng.integers(0, m, k)
    vv[repl] = (rng.random(k) * (high - low) + low).astype(np.float32)
    # de-dup (drop later duplicates of the same cell, same as ingest would)
    key = rr.astype(np.int64) * m + cc
    _, idx = np.unique(key, return_index=True)
    return rr[idx], cc[idx], vv[idx]


def main():
    import faulthandler
    faulthandler.dump_traceback_later(180, repeat=True, file=sys.stderr)
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--mode", default="hybrid",
                    help="solver mode (default: hybrid)")
    ap.add_argument("--sigma", type=float, default=10.0,
                    help="per-frame cost drift stddev (cost range 1..1000)")
    ap.add_argument("--warm", default="fr", choices=["raw", "relax", "fr"],
                    help="warm-price treatment for the warm arms: raw "
                         "duals, warm_relax=0.9 rollback, or the "
                         "forward-reverse dual tightening (round 5)")
    ap.add_argument("--families", default="ABC",
                    help="subset of drift families to run (A=value drift, "
                         "B=pattern churn, C=persistent pattern)")
    ap.add_argument("--gs-engine", default="forward",
                    choices=["forward", "fr"],
                    help="host finisher engine for ALL arms (round 5: "
                         "'fr' = combined forward-reverse auction)")
    ap.add_argument("--warm-eps-mult", type=float, default=4.0,
                    help="family B fr-warm eps_start = mult * sigma")
    ap.add_argument("--warm-theta", type=float, default=0.0,
                    help="family B fr-warm theta override (0 = default)")
    ap.add_argument("--sigma-persistent", type=float, default=0.5,
                    help="family C per-frame drift stddev (<= 0.1%% of the "
                         "1..1000 cost range: the persistent-pattern "
                         "tracking regime)")
    args = ap.parse_args()

    def warm_kwargs():
        return ({} if args.warm == "raw"
                else {"warm_relax": 0.9} if args.warm == "relax"
                else {"warm_mode": "fr"})

    import functools
    from sslap_tpu import AuctionSolver as _AuctionSolver, hopcroft_solve
    # One switch flips the host finisher for every arm (cold and warm):
    # the A/B contract is engine-vs-engine on identical workloads.
    AuctionSolver = functools.partial(_AuctionSolver,
                                      gs_engine=args.gs_engine)

    mode = args.mode

    import bench
    n = args.n
    rng = np.random.default_rng(0)
    rr, cc, vv = bench.make_instance(n, n, 9, seed=0)
    # bench.make_instance appends the feasibility permutation LAST and
    # de-dups; re-derive an anchor set = one edge per row via the solve
    # itself (the previous matching is the anchor in a real tracker).
    log(f"instance: {n}x{n} nnz={rr.shape[0]}")

    results = []
    carry = {}

    def frame(name, fn):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        rec = {"frame": name, "s": round(dt, 3), **out}
        results.append(rec)
        print(json.dumps(rec), flush=True)
        return dt

    # ---------------- family A: value drift, fixed pattern ---------------
    loc = np.stack([rr, cc], 1)

    def value_drift_family(tag, sigma, frames):
        """Cold-vs-warm frames under fixed-pattern value drift; warm
        prices are CHAINED frame to frame (the real tracker pattern --
        round 4 measured raw chained duals accumulating ~sigma relative
        error per frame and blowing up by frame 2-3; the --warm
        treatment is the mitigation under test)."""
        def frame0():
            solver = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode=mode,
                                   cardinality_check=True)
            res = solver.solve()
            carry["prices"] = res.get("prices")
            return {"obj": res["meta"]["obj"],
                    "host_bids": res["meta"]["host_bids"]}

        frame(f"{tag}0_cold_construct+hk+solve", frame0)
        prices = carry.pop("prices")

        vals_f = vv
        for f in range(1, frames + 1):
            vals_f = drift_values(vals_f, rng, sigma=sigma)

            # cold: fresh solver (re-ingest + HK + full schedule)
            def cold(vals_f=vals_f):
                s = AuctionSolver(loc=loc, val=vals_f, shape=(n, n),
                                  mode=mode, cardinality_check=True)
                r = s.solve()
                return {"obj": r["meta"]["obj"],
                        "host_bids": r["meta"]["host_bids"]}

            frame(f"{tag}{f}_cold", cold)

            # warm: no HK (pattern unchanged), chained warm prices,
            # drift-matched schedule (eps_start ~ 4x sigma)
            def warm(vals_f=vals_f, prices=prices):
                s = AuctionSolver(loc=loc, val=vals_f, shape=(n, n),
                                  mode=mode, cardinality_check=False,
                                  eps_start=4.0 * sigma)
                r = s.solve(warm_prices=prices, **warm_kwargs())
                carry["prices"] = r.get("prices")
                return {"obj": r["meta"]["obj"],
                        "host_bids": r["meta"]["host_bids"],
                        "phases": r["meta"]["phases"],
                        "found": r["meta"]["soln_found"]}

            frame(f"{tag}{f}_warm", warm)
            prices = carry.pop("prices")

    if "A" in args.families:
        value_drift_family("A", args.sigma, args.frames)

    # ------------- family C: persistent pattern, tiny drift --------------
    # The advertised warm-start regime (VERDICT r4 weak 3): a tracker whose
    # detections persist -- pattern FIXED, drift sigma <= 0.1% of the cost
    # range -- where the previous duals are nearly market-exact and warm
    # frames should collapse to a couple of cheap low-eps phases.
    if "C" in args.families:
        value_drift_family("C", args.sigma_persistent,
                           max(args.frames, 4))

    # ---------------- family B: pattern + value drift ---------------------
    if "B" in args.families:
        rrB, ccB, vvB = rr, cc, vv
        locB = np.stack([rrB, ccB], 1)
        log("family B: construct")
        sB = AuctionSolver(loc=locB, val=vvB, shape=(n, n), mode=mode,
                           cardinality_check=False)
        log("family B: pre-solve")
        rB = sB.solve()
        log("family B: pre-solve done")
        pricesB = rB.get("prices")
        matchB = rB["sol"]

        for f in range(1, args.frames + 1):
            mrows = np.flatnonzero(np.asarray(matchB) >= 0).astype(np.int64)
            protect = np.sort(mrows * np.int64(n)
                              + np.asarray(matchB)[mrows])
            rrB, ccB, vvB = drift_pattern(rrB, ccB, vvB, n, n, 0, rng,
                                          protect_keys=protect)
            vvB = drift_values(vvB, rng, sigma=args.sigma)
            locB = np.stack([rrB, ccB], 1)

            def coldB(locB=locB, vvB=vvB):
                s = AuctionSolver(loc=locB, val=vvB, shape=(n, n),
                                  mode=mode,
                                  cardinality_check=True)  # full cold HK
                r = s.solve()
                return {"obj": r["meta"]["obj"],
                        "host_bids": r["meta"]["host_bids"],
                        "feasible": r["meta"]["soln_found"]}

            frame(f"B{f}_cold", coldB)

            def warmB(locB=locB, vvB=vvB, pricesB=pricesB, matchB=matchB):
                t0 = time.perf_counter()
                mt = hopcroft_solve(loc=locB, shape=(n, n), warm=matchB)
                hk_s = time.perf_counter() - t0
                feasible = bool((mt >= 0).all())
                # Pattern churn is the forward auction's hard case: raw
                # eps-tight duals give displaced rows' chains no slack
                # (prices cannot move down).  The --warm treatment under
                # test repairs that: warm_relax=0.9 scalar rollback
                # (round 4) or the forward-reverse dual tightening
                # (round 5, warm_mode='fr').  Under raw/relaxed duals the
                # drift-matched eps_start shortcut blew the GS budget
                # (round 4: full schedule required); FR-tightened duals
                # are dual-FEASIBLE for the new costs, so the shortcut is
                # back on the table -- measured here, cold fallback below
                # guards it either way.
                skw = {}
                if args.warm == "fr":
                    skw["eps_start"] = args.warm_eps_mult * args.sigma
                    if args.warm_theta:
                        skw["theta"] = args.warm_theta
                s = AuctionSolver(loc=locB, val=vvB, shape=(n, n),
                                  mode=mode, cardinality_check=False,
                                  **skw)
                r = s.solve(warm_prices=pricesB, **warm_kwargs())
                fell_back = False
                if not r["meta"]["soln_found"]:
                    # Budget-trip safety: fall back to a cold solve inside
                    # the frame (the honest serving recipe).
                    fell_back = True
                    s = AuctionSolver(loc=locB, val=vvB, shape=(n, n),
                                      mode=mode, cardinality_check=False)
                    r = s.solve()
                carry["prices"] = r.get("prices")
                carry["sol"] = r["sol"]
                return {"obj": r["meta"]["obj"], "hk_s": round(hk_s, 3),
                        "host_bids": r["meta"]["host_bids"],
                        "found": r["meta"]["soln_found"],
                        "fell_back": fell_back,
                        "feasible": feasible}

            frame(f"B{f}_warm", warmB)
            pricesB = carry.pop("prices")
            matchB = carry.pop("sol")

    # ---------------- summary --------------------------------------------
    def fps(prefix, suffix):
        ts = [r["s"] for r in results
              if r["frame"].startswith(prefix)
              and r["frame"].endswith(suffix)]
        return round(len(ts) / sum(ts), 3) if ts else None

    summary = {
        "mode": mode, "n": n, "frames": args.frames, "warm": args.warm,
        "fps_value_drift_cold": fps("A", "_cold"),
        "fps_value_drift_warm": fps("A", "_warm"),
        "fps_pattern_drift_cold": fps("B", "_cold"),
        "fps_pattern_drift_warm": fps("B", "_warm"),
        "fps_persistent_cold": fps("C", "_cold"),
        "fps_persistent_warm": fps("C", "_warm"),
    }
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
