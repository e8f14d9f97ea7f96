"""Measure the per-round FIXED cost of compact_round inside a jitted
while chain at small tier capacities (high-rep two-point fit; the main
probe's r=1..5 fit is noise-dominated below ~1 ms).

Usage: python benchmarks/probe_round_overhead.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax import lax

from sslap_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from sslap_tpu import compact as C
    n = m = 2 ** 20
    K = 10
    rng = np.random.default_rng(0)
    cols = jnp.asarray(rng.integers(0, m, (n, K), dtype=np.int32))
    vals = jnp.asarray(rng.random((n, K)).astype(np.float32) * 1000)
    valid = jnp.ones((n, K), bool)
    nvalid = jnp.full((n,), K, jnp.int32)
    rowpack = C.build_rowpack(cols, C.mask_vals(vals, valid), nvalid)
    p0 = jnp.asarray(rng.random(m).astype(np.float32))
    owner0 = jnp.full((m,), -1, jnp.int32)
    sigma0 = jnp.full((n,), -1, jnp.int32)
    bigp = jnp.float32(1001.0)

    for Ccap in (64, 256, 1024, 4096, 16384):
        ids0 = jnp.asarray(np.sort(
            rng.choice(n, Ccap, replace=False)).astype(np.int32))

        def run_R(R):
            @jax.jit
            def f(prices, owner, sigma, ids):
                def body(i, c):
                    prices, owner, sigma, ids, acc = c
                    prices, owner, sigma, ids, n_won, n_evi = \
                        C.compact_round(rowpack, prices, owner, sigma,
                                        ids, jnp.float32(1.0), bigp)
                    return (prices, owner, sigma, ids, acc + n_won)
                c = lax.fori_loop(0, R, body,
                                  (prices, owner, sigma, ids, jnp.int32(0)))
                return c[4] + jnp.sum(c[0].ravel()[:2]).astype(jnp.int32)
            v = float(np.asarray(f(p0, owner0, sigma0, ids0)))
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                v = float(np.asarray(f(p0, owner0, sigma0, ids0)))
                best = min(best, time.perf_counter() - t0)
            return best

        t_lo, t_hi = run_R(40), run_R(240)
        per_round = (t_hi - t_lo) / 200
        log(f"C={Ccap:6d}: {per_round*1e6:8.1f} us/round "
            f"(work term ~{Ccap*K*21e-3:7.1f} us)")


if __name__ == "__main__":
    main()
