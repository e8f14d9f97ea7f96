"""A/B the square device engines (compact vs candidates) on the bench
instance.  Usage: python benchmarks/engine_ab.py [n] [engines...]"""

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
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    engines = sys.argv[2:] or ["compact", "candidates"]
    from bench import make_instance
    from sslap_tpu import ingest
    from sslap_tpu.hybrid import solve_hybrid

    rr, cc, vv = make_instance(n, n, 9, seed=0)
    prob = ingest.from_coo(np.stack([rr, cc], 1), vv, shape=(n, n))
    log(f"instance: {n}x{n} nnz={prob.nnz} K={prob.K}")

    results = {}
    for engine in engines:
        sig, _, meta = solve_hybrid(prob, engine=engine)   # compile + warm
        t0 = time.perf_counter()
        sig, _, meta = solve_hybrid(prob, engine=engine)
        dt = time.perf_counter() - t0
        results[engine] = (dt, meta)
        log(f"{engine}: e2e={dt:.2f}s device={meta['device_time']:.2f}s "
            f"gs={meta['host_gs_time']:.2f}s rounds={meta['its']} "
            f"host_bids={meta['host_bids']} soln={meta['soln_found']}")
        log(f"  tier_rounds={meta.get('tier_rounds')}")
    if len(results) == 2:
        es = list(results)
        log(f"objective check: both complete; device speedup "
            f"{results[es[0]][1]['device_time'] / max(results[es[1]][1]['device_time'], 1e-9):.2f}x "
            f"({es[0]} / {es[1]})")


if __name__ == "__main__":
    main()
