"""A/B: scalar-gather full-width bid round vs the window-gather round
(ops/widebid.py) -- VERDICT r3 task 6's go/no-go measurement.

Both sides compute the COMPLETE wide-round bid (w, top-2, jstar, bid)
on the same 1M x 1M / 10 nnz/row instance; parity is asserted
bit-identical first, then both are timed with a chained two-point fit
(cancels dispatch and readback constants).

Decision rule (VERDICT r3): keep the window round only if it beats the
scalar-gather round end-to-end; either way the number goes in PERF.md.

Usage: python benchmarks/probe_widebid.py [--n 1048576] [--k 10]
"""

from __future__ import annotations

import argparse
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


def chain_time(step, carry0, r1=1, r2=4):
    def scalarize(tree):
        leaves = jax.tree_util.tree_leaves(tree)
        acc = jnp.float32(0)
        for leaf in leaves:
            acc = acc + jnp.sum(leaf.ravel()[:4]).astype(jnp.float32)
        return acc

    ts = {}
    for R in (r1, r2):
        run = jax.jit(lambda carry, R=R: scalarize(
            lax.fori_loop(0, R, lambda i, c: step(c), carry)))
        float(np.asarray(run(carry0)))
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            float(np.asarray(run(carry0)))
            best = min(best, time.perf_counter() - t0)
        ts[R] = best
    return max((ts[r2] - ts[r1]) / (r2 - r1), 1e-9)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args()

    from sslap_tpu.ops.widebid import build_wide_layout, wide_w

    n = m = args.n
    K = args.k
    nnz = n * K
    rng = np.random.default_rng(0)
    cols_np = rng.integers(0, m, (n, K), dtype=np.int32)
    vals_np = (rng.random((n, K)) * 1000).astype(np.float32)
    valid_np = np.ones((n, K), bool)
    log(f"devices: {jax.devices()}  instance n=m={n} K={K} nnz={nnz}")

    t0 = time.perf_counter()
    layout = build_wide_layout(cols_np, vals_np, valid_np, m)
    log(f"layout build (host, one-time): {time.perf_counter()-t0:.2f}s  "
        f"E={layout.coff.shape[1]} pad={layout.coff.size/nnz-1:.1%}")

    cols = jnp.asarray(cols_np)
    vals = jnp.asarray(vals_np)
    p0 = jnp.asarray(rng.random(m).astype(np.float32) * 1000)
    neg = jnp.float32(np.float32(np.finfo(np.float32).min))

    def top2(w):
        slot = jnp.argmax(w, axis=1)
        oh = jnp.arange(K, dtype=jnp.int32)[None, :] == slot[:, None]
        v1 = jnp.max(w, axis=1)
        v2 = jnp.max(jnp.where(oh, neg, w), axis=1)
        jstar = jnp.sum(jnp.where(oh, cols, 0), axis=1)
        return v1, v2, jstar

    def scalar_round(p):
        w = vals - p[cols]
        return top2(w)

    def window_round(p):
        w = wide_w(layout, p)
        return top2(w)

    # ---- parity (bit-identical w, identical top-2) ----------------------
    a = jax.jit(scalar_round)(p0)
    b = jax.jit(window_round)(p0)
    ok = all(bool(jnp.array_equal(x, y)) for x, y in zip(a, b))
    log(f"parity: {'OK (bit-identical)' if ok else 'MISMATCH'}")
    if not ok:
        for name, x, y in zip(("v1", "v2", "jstar"), a, b):
            bad = int(jnp.sum(x != y))
            log(f"  {name}: {bad} mismatches")
        print("PARITY FAIL")
        return

    # ---- timing ----------------------------------------------------------
    def perturb(p, out):
        return p + (out[0][0] + out[1][0]).astype(p.dtype) * 1e-30

    def step_scalar(c):
        p, acc = c
        out = scalar_round(p)
        return (perturb(p, out), acc + out[0][0])

    def step_window(c):
        p, acc = c
        out = window_round(p)
        return (perturb(p, out), acc + out[0][0])

    dt_s = chain_time(step_scalar, (p0, jnp.float32(0)))
    log(f"scalar-gather round: {dt_s*1e3:.2f} ms  "
        f"({dt_s*1e9/nnz:.2f} ns/elem)")
    dt_w = chain_time(step_window, (p0, jnp.float32(0)))
    log(f"window-gather round: {dt_w*1e3:.2f} ms  "
        f"({dt_w*1e9/nnz:.2f} ns/elem)")
    verdict = "WINDOW WINS" if dt_w < dt_s else "SCALAR WINS"
    print(f"{verdict}: scalar {dt_s*1e3:.2f} ms vs window {dt_w*1e3:.2f} ms "
          f"(ratio {dt_s/dt_w:.2f}x) at n={n} K={K}")

    # Stage split for the window round: gather-only vs join-only.
    from sslap_tpu.ops import widebid as _wb

    def step_gather_only(c):
        p, acc = c
        pp = jnp.pad(p, (0, layout.m_pad - m)) if m < layout.m_pad else p
        p2d = pp.reshape(-1, 128)
        iota = jnp.arange(128, dtype=jnp.int32)
        oh = layout.coff[..., None] == iota
        pg = jnp.sum(jnp.where(oh, p2d[:, None, :], 0.0), axis=-1)
        w_cg = layout.vals_cg - pg
        return (p + w_cg[0, 0] * 1e-30, acc + w_cg[0, 0])

    dt_g = chain_time(step_gather_only, (p0, jnp.float32(0)))
    log(f"  stage gather-only: {dt_g*1e3:.2f} ms "
        f"({dt_g*1e9/nnz:.2f} ns/elem)")

    wflat0 = jnp.asarray(rng.random(layout.dest.shape[0]).astype(np.float32))

    def step_join_only(c):
        wflat, acc = c
        _, ws = lax.sort((layout.dest, wflat), num_keys=1)
        return (wflat + ws[0] * 1e-30, acc + ws[0])

    dt_j = chain_time(step_join_only, (wflat0, jnp.float32(0)))
    log(f"  stage join-only (pair sort): {dt_j*1e3:.2f} ms "
        f"({dt_j*1e9/nnz:.2f} ns/elem)")


if __name__ == "__main__":
    main()
