"""Round-4 ladder experiments on the headline 1M instance, one chip
session (construct-once, transfers amortized):

  A. trunc re-sweep (256/384/512) under the SHIPPED schedule (theta=10 +
     theta_tail=3 + wide rounds).  The round-3 sweep that pinned
     trunc=256 predates both the mixed tail and the wide rounds; the
     tail-bid explosion it measured at trunc=512 may be gone.  trunc is
     traced -- no recompile per value.
  B. fine-ladder A/B: default (floor-pruned, 17 tiers at 1M) vs
     fine={2^k, 3*2^(k-1)} interleave below 32768 (24 tiers).  Capacity
     only pads -- results bit-identical -- so this is purely a
     device-pass measurement: model says the sub-32768 tiers hold ~12M
     row-fetches at 1.44x slack, the fine ladder cuts that to ~1.2x
     (~0.2-0.25 s).  Run LAST: a deep-ladder compile can be slow
     (PERF.md round 3: the 25-tier ladder never finished in 40 min).

Usage: python benchmarks/bench_ladder_ab.py [--n N] [--reps 2]
       [--skip-fine] [--truncs 256,384,512]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--skip-fine", action="store_true")
    ap.add_argument("--only-fine", action="store_true",
                    help="skip the default-ladder arm (round 5: fine is "
                         "the shipped default; sweep truncs on it alone)")
    ap.add_argument("--truncs", type=str, default="256,384,512")
    args = ap.parse_args()

    import bench
    from sslap_tpu import ingest
    from sslap_tpu import hybrid as H

    n = args.n
    rr, cc, vv = bench.make_instance(n, n, 9, seed=0)
    loc = np.stack([rr, cc], 1)
    prob = ingest.from_coo(loc, vv, shape=(n, n))
    log(f"instance {n}x{n} nnz={rr.shape[0]}")

    def steady(fine, trunc, cache, reps):
        # Each (fine, trunc) pair owns a distinct floor-pruned tier tuple
        # -> its own XLA program; warm it OFF the clock (the round-5 sweep
        # had to quote band minima because rep 1 of non-warmed cells
        # carried a fresh 2-4 min compile).
        t0 = time.perf_counter()
        H.solve_hybrid(prob, trunc=trunc, device_cache=cache,
                       fine_ladder=fine)
        log(f"warm fine={fine} trunc={trunc}: "
            f"{time.perf_counter() - t0:.1f}s")
        times, devs, gss, bids = [], [], [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            sol, prices, meta = H.solve_hybrid(
                prob, trunc=trunc, device_cache=cache, fine_ladder=fine)
            times.append(time.perf_counter() - t0)
            assert meta["soln_found"], meta
            devs.append(meta["device_time"])
            gss.append(meta["host_gs_time"])
            bids.append(meta["host_bids"])
        return {
            "fine": fine, "trunc": trunc,
            "steady_s": round(float(np.median(times)), 3),
            "band": [round(min(times), 3), round(max(times), 3)],
            "device_s": round(float(np.median(devs)), 3),
            "gs_s": round(float(np.median(gss)), 3),
            "gs_bids": int(np.median(bids)),
            "obj_probe": float(np.sum(np.asarray(prices)[:4])),
        }

    truncs = [int(t) for t in args.truncs.split(",")]
    cache = {}
    if not args.only_fine:
        # Default (floor-pruned) ladder: warm once, then the trunc sweep.
        t0 = time.perf_counter()
        H.solve_hybrid(prob, trunc=truncs[0], device_cache=cache,
                       fine_ladder=False)
        log(f"default-ladder warm (compile+H2D): "
            f"{time.perf_counter() - t0:.1f}s")
        for trunc in truncs:
            cell = steady(False, trunc, cache, args.reps)
            print(json.dumps(cell), flush=True)

    if args.skip_fine:
        return
    # Fine ladder (new program; compile timed separately).
    t0 = time.perf_counter()
    H.solve_hybrid(prob, trunc=truncs[0], device_cache=cache,
                   fine_ladder=True)
    log(f"fine-ladder warm (compile): {time.perf_counter() - t0:.1f}s")
    for trunc in truncs:
        cell = steady(True, trunc, cache, args.reps)
        print(json.dumps(cell), flush=True)


if __name__ == "__main__":
    main()
