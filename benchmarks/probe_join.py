"""Wide-round join alternatives probe (VERDICT r4 task 2).

The wide round's static sort-join (lax.sort (dest i32, w f32) pairs,
3.5 ns/elem measured round 2, 37 of 46.3 ms per wide round at 1M) is the
remaining measured lever on the round cost.  The permutation is STATIC
(known at layout-build time), so this probe measures every primitive a
static-permutation apply could be built from, plus complete candidate
joins, on the real chip:

  A. pair_sort        lax.sort((dest, w), num_keys=1)    -- the baseline
  B. u64_sort         single-array sort of (dest << 32 | w_bits), unpack
  C. take_static      w[perm] with a build-time argsort(dest) (gather)
  D. onehot128_perm   within-row 128-lane static permutation via one-hot
                      compare+select on a [A, 128] view -- the Clos-stage
                      primitive
  E. transpose        [A, 128] <-> [128, A] forced materialization -- the
                      Clos inter-stage primitive

Decision arithmetic documented in PERF.md: a general static permutation
via 128-wide one-hot routing needs ~2*log_128(N) ~= 7 stages of D plus
~6 of E; if 7*D + 6*E >= A, the sort IS the floor on this stack and the
task closes as a measured negative.

DMA-routed stores are RULED OUT (round-4 probe: crash-free but wrong
data, coherence hazard) and are not re-tried here.

Usage: python benchmarks/probe_join.py [--n 1048576] [--k 10]
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
    """Two-point chained timing: the per-step cost is the slope between r1
    and r2 chained iterations, insulating the number from dispatch and
    readback latency."""
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

    N = args.n * args.k                      # elements to permute
    rng = np.random.default_rng(0)
    perm_np = rng.permutation(N).astype(np.int32)   # dest[i] of source i
    w0 = jnp.asarray((rng.random(N) * 1000).astype(np.float32))
    dest = jnp.asarray(perm_np)
    inv_np = np.empty(N, np.int64)
    inv_np[perm_np] = np.arange(N)
    inv = jnp.asarray(inv_np.astype(np.int32))      # src index per output
    log(f"devices: {jax.devices()}  N={N}")
    results = {}

    # A. pair sort (baseline)
    def step_pair(w):
        _, ws = lax.sort((dest, w), num_keys=1)
        return ws + jnp.float32(1.0)       # data dependence across steps

    s = chain_time(step_pair, w0)
    results["A_pair_sort"] = s / N
    log(f"A pair_sort      {s*1e3:8.2f} ms  {s/N*1e9:6.2f} ns/elem")

    # B. packed u64 single-key sort.  Key = dest<<32 | monotone(w_bits):
    # for the probe only the MOVEMENT cost matters, so pack the raw bits.
    def step_u64(w):
        key = (dest.astype(jnp.uint64) << 32) | \
            lax.bitcast_convert_type(w, jnp.uint32).astype(jnp.uint64)
        ks = lax.sort(key)
        ws = lax.bitcast_convert_type(
            (ks & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32), jnp.float32)
        return ws + jnp.float32(1.0)

    if not jax.config.jax_enable_x64:
        # Without x64 the uint64 silently TRUNCATES to uint32 and the
        # "sort" measures a meaningless single-u32 sort (first run of this
        # probe did exactly that).  Run JAX_ENABLE_X64=1 for this arm.
        results["B_u64_sort"] = None
        log("B u64_sort       SKIPPED (needs JAX_ENABLE_X64=1; u64 "
            "truncates to u32 otherwise)")
    else:
        try:
            s = chain_time(step_u64, w0)
            results["B_u64_sort"] = s / N
            log(f"B u64_sort       {s*1e3:8.2f} ms  {s/N*1e9:6.2f} ns/elem")
        except Exception as e:               # u64 may not lower everywhere
            results["B_u64_sort"] = None
            log(f"B u64_sort       FAILED: "
                f"{type(e).__name__}: {str(e)[:120]}")

    # C. static gather (known-permutation apply via take)
    def step_take(w):
        return jnp.take(w, inv) + jnp.float32(1.0)

    s = chain_time(step_take, w0)
    results["C_take_static"] = s / N
    log(f"C take_static    {s*1e3:8.2f} ms  {s/N*1e9:6.2f} ns/elem")

    # D. one-hot within-row 128-perm (the Clos stage primitive)
    A = N // 128
    idx128 = jnp.asarray(
        np.argsort(rng.random((A, 128)), axis=1).astype(np.int32))
    iota = jnp.arange(128, dtype=jnp.int32)

    def step_onehot(w):
        w2 = w.reshape(A, 128)
        oh = idx128[..., None] == iota                  # [A, 128, 128]
        out = jnp.sum(jnp.where(oh, w2[:, None, :], jnp.float32(0)),
                      axis=-1)
        return out.reshape(-1) + jnp.float32(1.0)

    s = chain_time(step_onehot, w0)
    results["D_onehot128"] = s / N
    log(f"D onehot128_perm {s*1e3:8.2f} ms  {s/N*1e9:6.2f} ns/elem")

    # E. forced transpose [A, 128] -> [128, A] (Clos inter-stage).  The
    # +1.0 and the reshape round-trip force materialization each step.
    def step_transpose(w):
        w2 = w.reshape(A, 128).T
        return w2.reshape(-1) + jnp.float32(1.0)

    s = chain_time(step_transpose, w0)
    results["E_transpose"] = s / N
    log(f"E transpose      {s*1e3:8.2f} ms  {s/N*1e9:6.2f} ns/elem")

    # F/G. Beneš-style pipelines: alternating static within-row 128-lane
    # permutations and stride-128 relabels ([A,128] -> T -> flatten ->
    # re-view [A,128]).  Random static routes (cost model only -- a real
    # join needs the routing computed at build time); parity vs numpy
    # asserts nothing was elided.
    def make_clos(idx_list_np):
        idxs = [jnp.asarray(i) for i in idx_list_np]

        def step(w):
            x = w
            for idx in idxs:
                x2 = x.reshape(A, 128)
                oh = idx[..., None] == iota
                x2 = jnp.sum(jnp.where(oh, x2[:, None, :], jnp.float32(0)),
                             axis=-1)
                x = x2.T.reshape(-1)
            return x + jnp.float32(1.0)

        def ref(wn):
            x = wn
            for i in idx_list_np:
                x2 = np.take_along_axis(x.reshape(A, 128), i, axis=1)
                x = x2.T.reshape(-1)
            return x + np.float32(1.0)

        return step, ref

    for nstage, tag in ((3, "F_clos3"), (6, "G_clos6")):
        idx_list_np = [
            np.argsort(rng.random((A, 128)), axis=1).astype(np.int32)
            for _ in range(nstage)]
        step_c, ref_c = make_clos(idx_list_np)
        got = np.asarray(jax.jit(step_c)(w0))
        want = ref_c(np.asarray(w0))
        assert np.array_equal(got, want), f"{tag} parity FAILED (elided?)"
        s = chain_time(step_c, w0)
        results[tag] = s / N
        log(f"{tag:15s}  {s*1e3:8.2f} ms  {s/N*1e9:6.2f} ns/elem "
            f"({s/N/nstage*1e9:.3f} ns/stage-elem)")

    # Parity spot-checks (cheap, off the clock)
    ws = np.asarray(jax.jit(lambda w: lax.sort((dest, w), num_keys=1)[1])(w0))
    wt = np.asarray(jax.jit(lambda w: jnp.take(w, inv))(w0))
    assert np.array_equal(ws, wt), "sort-join and take disagree"
    # D parity (one application): one-hot within-row perm == take_along_axis
    got = np.asarray(jax.jit(step_onehot)(w0))
    want = (np.take_along_axis(np.asarray(w0).reshape(A, 128),
                               np.asarray(idx128), axis=1).reshape(-1)
            + np.float32(1.0))
    assert np.array_equal(got, want), "D parity FAILED (elided?)"

    d = results.get("D_onehot128")
    e = results.get("E_transpose")
    if d is not None and e is not None:
        clos = 7 * d + 6 * e
        log(f"Clos-floor arithmetic: 7*D + 6*E = {clos*1e9:.2f} ns/elem "
            f"vs A = {results['A_pair_sort']*1e9:.2f}")
    import json
    print(json.dumps({k: (None if v is None else round(v * 1e9, 3))
                      for k, v in results.items()}), flush=True)


if __name__ == "__main__":
    main()
