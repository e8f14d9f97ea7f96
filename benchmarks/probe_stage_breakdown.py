"""Stage-wise cost breakdown of compact_round at several tier capacities
(round 3, VERDICT task 2: find the ~2.5x overhead beyond the bare price
gathers and trim it).

Stages, each timed as a chained-in-jit two-point fit (cancels dispatch and
readback constants):

  fetch      one slice gather per active row + R-slot one-hot select
  bid        + price gather [C, K] + masked top-2 + bid arithmetic
  resolve    + conflict resolution (all-pairs <= pairs_max else scatter)
  full       the production compact_round (commit scatters + relist merge)

Usage: python benchmarks/probe_stage_breakdown.py [--small]
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


def two_point(run, r1, r2):
    run(r1)()                       # compile
    def best_of(f, reps=2):
        b = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            f()
            b = min(b, time.perf_counter() - t0)
        return b
    f1, f2 = run(r1), run(r2)
    t1, t2 = best_of(f1), best_of(f2)
    return max((t2 - t1) / (r2 - r1), 1e-9)


def main():
    small = "--small" in sys.argv
    # --big: diagnose the 10M scale run's device pass (1338 s measured,
    # ~15x above the weighted gather-cost model, PERF.md round-3) --
    # capacity-scale n to the scale config's top ladder tiers to see which
    # stage's ns/elem blows up at multi-million C.
    big = "--big" in sys.argv
    from sslap_tpu import compact as C
    from sslap_tpu.auction import neg_sentinel, neg_sentinel_value
    n = m = 2 ** 16 if small else (2 ** 23 if big else 2 ** 20)
    K = 10
    rng = np.random.default_rng(0)
    cols = jnp.asarray(np.sort(
        rng.integers(0, m, (n, K), dtype=np.int32), axis=1))
    vals = jnp.asarray(rng.random((n, K)).astype(np.float32) * 1000)
    valid = jnp.ones((n, K), bool)
    nvalid = jnp.full((n,), K, jnp.int32)
    rowpack = C.build_rowpack(cols, C.mask_vals(vals, valid), nvalid)
    p0 = jnp.asarray(rng.random(m).astype(np.float32))
    owner0 = jnp.full((m,), -1, jnp.int32)
    sigma0 = jnp.full((n,), -1, jnp.int32)
    bigp = jnp.float32(1001.0)
    neg = neg_sentinel(jnp.float32)
    dtype = jnp.float32
    _I32_MAX = 2 ** 31 - 1

    def stage_fn(stage, Ccap, pairs_max):
        def round_fn(prices, owner, sigma, ids, acc):
            live = ids < n
            pk = C.fetch_rows(rowpack, ids)
            colsC, valsC, nvC = C._unpack_rows(pk, dtype)
            nvC = jnp.where(live, nvC, 0)
            if stage == "fetch":
                return (prices + acc * 1e-30, owner, sigma, ids,
                        acc + jnp.sum(colsC[:, 0]).astype(jnp.float32))
            w = valsC - prices[colsC]
            slot = jnp.argmax(w, axis=1)
            onehot = (jnp.arange(K, dtype=jnp.int32)[None, :]
                      == slot[:, None])
            v1 = jnp.max(w, axis=1)
            v2 = jnp.max(jnp.where(onehot, neg, w), axis=1)
            v2 = jnp.where(nvC >= 2, v2, v1 - bigp)
            a_star = jnp.sum(jnp.where(onehot, valsC,
                                       jnp.zeros_like(valsC)), axis=1)
            jstar = jnp.sum(jnp.where(onehot, colsC, 0),
                            axis=1).astype(jnp.int32)
            bid = a_star - v2 + jnp.float32(1.0)
            bidding = live & (nvC > 0)
            tgt = jnp.where(bidding, jstar, jnp.int32(m))
            if stage == "bid":
                return (prices + acc * 1e-30, owner, sigma, ids,
                        acc + jnp.sum(bid) * 1e-30 + 1.0)
            if Ccap <= pairs_max:
                same = tgt[:, None] == tgt[None, :]
                beats = same & ((bid[None, :] > bid[:, None]) |
                                ((bid[None, :] == bid[:, None]) &
                                 (ids[None, :] < ids[:, None])))
                won = bidding & jnp.logical_not(jnp.any(beats, axis=1))
            else:
                best = (jnp.full((m,), neg, dtype)
                        .at[tgt].max(bid, mode="drop"))
                is_best = bid == best.at[tgt].get(
                    mode="fill", fill_value=neg_sentinel_value(dtype))
                cand = jnp.where(is_best, ids, jnp.int32(_I32_MAX))
                winner = (jnp.full((m,), _I32_MAX, jnp.int32)
                          .at[tgt].min(cand, mode="drop"))
                won = is_best & (winner.at[tgt].get(
                    mode="fill", fill_value=_I32_MAX) == ids)
            if stage == "resolve":
                return (prices + acc * 1e-30, owner, sigma, ids,
                        acc + jnp.sum(won).astype(jnp.float32) * 1e-30 + 1.)
            raise AssertionError(stage)
        return round_fn

    results = {}
    caps = ((65536, 524288, 2097152, 8388608) if big
            else (256, 1024, 4096, 8192, 16384))
    for Ccap in caps:
        ids0 = jnp.asarray(np.sort(
            rng.choice(n, Ccap, replace=False)).astype(np.int32))
        reps = max(2, min(400, int(3e8 // (Ccap * K))))
        row = {}
        for stage in ("fetch", "bid", "resolve", "resolve_scatter", "full"):
            pairs_max = 0 if stage == "resolve_scatter" else 8192
            st = "resolve" if stage == "resolve_scatter" else stage

            def run(R, st=st, pairs_max=pairs_max):
                if st == "full":
                    @jax.jit
                    def f(prices, owner, sigma, ids):
                        def body(i, c):
                            prices, owner, sigma, ids, acc = c
                            prices, owner, sigma, ids, nw, ne = \
                                C.compact_round(rowpack, prices, owner,
                                                sigma, ids,
                                                jnp.float32(1.0), bigp,
                                                pairs_resolve_max=pairs_max
                                                if pairs_max else 8192)
                            return (prices, owner, sigma, ids,
                                    acc + nw.astype(jnp.float32))
                        c = lax.fori_loop(
                            0, R, body,
                            (prices, owner, sigma, ids, jnp.float32(0)))
                        return c[4] + jnp.sum(c[0][:4])
                else:
                    rf = stage_fn(st, Ccap, pairs_max)

                    @jax.jit
                    def f(prices, owner, sigma, ids):
                        def body(i, c):
                            return rf(*c)
                        c = lax.fori_loop(
                            0, R, body,
                            (prices, owner, sigma, ids, jnp.float32(0)))
                        return c[4] + jnp.sum(c[0][:4])
                return lambda: float(np.asarray(
                    f(p0, owner0, sigma0, ids0)))
            dt = two_point(run, max(reps // 10, 1), reps)
            row[stage] = dt
            log(f"C={Ccap:6d} {stage:16s} {dt*1e6:9.1f} us/round "
                f"{dt / (Ccap * K) * 1e9:7.2f} ns/elem")
        results[Ccap] = row
    log("")
    log("deltas (us/round):")
    for Ccap, row in results.items():
        log(f"C={Ccap:6d} fetch={row['fetch']*1e6:7.1f} "
            f"+gather/top2={(row['bid']-row['fetch'])*1e6:7.1f} "
            f"+pairs_resolve={(row['resolve']-row['bid'])*1e6:7.1f} "
            f"+scatter_resolve={(row['resolve_scatter']-row['bid'])*1e6:7.1f} "
            f"+commit/merge={(row['full']-row['resolve'])*1e6:7.1f} "
            f"full={row['full']*1e6:7.1f}")


if __name__ == "__main__":
    main()
