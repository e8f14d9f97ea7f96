"""Steady-state A/B of the window-gather wide rounds inside the full
hybrid engine at the headline size (1M x 1M, 10 nnz/row): wide_rounds
False vs True on the SAME construct-once solver pattern, 3 reps each.

Usage: python benchmarks/bench_wide_ab.py [--n 1000000] [--reps 3]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import bench
    from sslap_tpu import AuctionSolver

    n = args.n
    rr, cc, vv = bench.make_instance(n, n, 9, seed=0)
    loc = np.stack([rr, cc], 1)
    print(f"instance {n}x{n} nnz={rr.shape[0]}", file=sys.stderr, flush=True)

    out = {}
    for wide in (False, True):
        s = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="hybrid",
                          cardinality_check=False, wide_rounds=wide)
        r = s.solve()                      # compile + transfer warmup
        times, devs, gss = [], [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            r = s.solve()
            times.append(time.perf_counter() - t0)
            devs.append(r["meta"].get("device_time", 0.0))
            gss.append(r["meta"].get("host_gs_time", 0.0))
        out[f"wide={wide}"] = {
            "steady_s": round(float(np.median(times)), 3),
            "band": [round(min(times), 3), round(max(times), 3)],
            "device_s": round(float(np.median(devs)), 3),
            "gs_s": round(float(np.median(gss)), 3),
            "obj": r["meta"]["obj"],
            "tier_rounds_head": r["meta"].get("tier_rounds", [])[:6],
            "its": r["meta"]["its"],
        }
        print(json.dumps({f"wide={wide}": out[f"wide={wide}"]}), flush=True)

    a, b = out["wide=False"], out["wide=True"]
    same = abs(a["obj"] - b["obj"]) < 1e-6 * max(abs(a["obj"]), 1)
    print(json.dumps({
        "obj_match": bool(same),
        "device_delta_s": round(a["device_s"] - b["device_s"], 3),
        "e2e_delta_s": round(a["steady_s"] - b["steady_s"], 3),
        "verdict": ("WIDE WINS" if b["steady_s"] < a["steady_s"]
                    else "SCALAR WINS"),
    }), flush=True)


if __name__ == "__main__":
    main()
