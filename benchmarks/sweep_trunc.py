"""Sweep the hybrid's phase-truncation point on the 1M bench instance
(round 3, VERDICT task 2): trunc sets where the device stops grinding
narrow eviction-chain rounds and hands the phase to the host GS tail.
Higher trunc = fewer device ladder rounds but a worse-preconditioned
final GS pass.

Usage: python benchmarks/sweep_trunc.py [--small]
"""

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
    small = "--small" in sys.argv
    n = 50_000 if small else 1_000_000
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench import make_instance   # the canonical bench instance

    rr, cc, vv = make_instance(n, n, 9, seed=0)
    loc = np.stack([rr, cc], 1)
    from sslap_tpu import ingest
    from sslap_tpu import hybrid as H
    prob = ingest.from_coo(loc, vv, shape=(n, n))

    cache = {}
    if "--truncs" in sys.argv:
        truncs = tuple(int(t) for t in
                       sys.argv[sys.argv.index("--truncs") + 1].split(","))
    elif "--down" in sys.argv:
        truncs = (64, 128, 192, 256, 512)
    else:
        truncs = (256, 512, 1024, 2048, 4096)
    for trunc in truncs:
        # warm (compile for this trunc is shared: trunc is traced)
        sol, prices, meta = H.solve_hybrid(prob, trunc=trunc,
                                           device_cache=cache)
        t0 = time.perf_counter()
        sol, prices, meta = H.solve_hybrid(prob, trunc=trunc,
                                           device_cache=cache)
        dt = time.perf_counter() - t0
        assert meta["soln_found"], meta
        log(f"trunc={trunc:5d}: e2e {dt:6.2f}s device "
            f"{meta['device_time']:6.2f}s gs {meta['host_gs_time']:5.2f}s "
            f"gs_bids {meta['host_bids']:9d} rounds {meta['its']:6d}")


if __name__ == "__main__":
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    main()
