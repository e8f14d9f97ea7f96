"""Size x density sweep vs scipy — the reference's README benchmark
surface (SURVEY.md §3a R6: "speed comparison scripts vs scipy/lap/
lapsolver across size/density").

Sparse cells: `auction_solve(loc=..., val=...)` vs
`scipy.sparse.csgraph.min_weight_full_bipartite_matching` (the only scipy
entry that accepts sparsity).  Dense cells: `auction_solve(mat)` vs
`scipy.optimize.linear_sum_assignment`.  Integer costs so objectives must
match scipy EXACTLY (asserted); `lap` / `lapsolver` are not in this
environment, scipy is the surviving competitor.

One JSON line per cell on stdout; a markdown table on stderr for
README.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sparse_case(n, m, k, seed):
    from benchmarks.run_all import make_sparse
    return make_sparse(n, m, k, seed=seed, integer=True, high=10_000)


def run_sparse(n, k, seed=11, reps=None, m=None):
    """Square (m=None) or rectangular (n < m) sparse cell.  Rectangular
    instances exercise the implicit-dummy per-phase path (SURVEY.md §1
    item 1; VERDICT r4 weak 5 asked for rect perf evidence) against the
    same scipy oracle -- min_weight_full_bipartite_matching matches all n
    rows of an n x m (n <= m) matrix."""
    m = n if m is None else m
    if reps is None:
        # The scipy oracle at n >= 1M runs tens of minutes per rep; one
        # rep there keeps the full sweep bounded (ours still gets medians
        # at the sizes where reps are cheap).
        reps = 1 if n >= 1_000_000 else 3
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching

    from sslap_tpu import auction_solve

    loc, val = _sparse_case(n, m, k, seed)
    sp = csr_matrix((val.astype(np.float64), (loc[:, 0], loc[:, 1])),
                    shape=(n, m))

    ours = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = auction_solve(loc=loc, val=val, shape=(n, m))
        ours.append(time.perf_counter() - t0)
    theirs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r, c = min_weight_full_bipartite_matching(sp)
        theirs.append(time.perf_counter() - t0)
    obj_scipy = int(sp[r, c].sum())
    assert int(res["meta"]["obj"]) == obj_scipy, (res["meta"]["obj"],
                                                  obj_scipy)
    return {"kind": "sparse" if n == m else "sparse_rect", "n": n, "m": m,
            "nnz": int(val.shape[0]),
            "nnz_per_row": k, "ours_s": round(float(np.median(ours)), 4),
            "scipy_s": round(float(np.median(theirs)), 4),
            "speedup": round(float(np.median(theirs) / np.median(ours)), 2),
            "mode": res["meta"]["mode"], "exact": True}


def run_dense(n, seed=13, reps=3):
    from scipy.optimize import linear_sum_assignment

    from sslap_tpu import auction_solve

    rng = np.random.default_rng(seed)
    C = rng.integers(1, 10_000, (n, n)).astype(np.int64)

    ours = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = auction_solve(C)
        ours.append(time.perf_counter() - t0)
    theirs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r, c = linear_sum_assignment(C)
        theirs.append(time.perf_counter() - t0)
    obj_scipy = int(C[r, c].sum())
    assert int(res["meta"]["obj"]) == obj_scipy
    return {"kind": "dense", "n": n,
            "ours_s": round(float(np.median(ours)), 4),
            "scipy_s": round(float(np.median(theirs)), 4),
            "speedup": round(float(np.median(theirs) / np.median(ours)), 2),
            "mode": res["meta"]["mode"], "exact": True}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller grid (CI-sized)")
    ap.add_argument("--only", default="",
                    help="comma subset of {dense,sparse,rect} to run")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None

    if args.quick:
        sparse_grid = [(1000, 5), (1000, 20), (10_000, 5)]
        rect_grid = [(1000, 2000, 5)]
        dense_grid = [256, 1024]
    else:
        sparse_grid = [(1000, 5), (1000, 20), (10_000, 5), (10_000, 20),
                       (100_000, 5), (100_000, 20), (1_000_000, 10)]
        rect_grid = [(10_000, 20_000, 10), (100_000, 200_000, 10),
                     (1_000_000, 2_000_000, 10)]
        dense_grid = [256, 1024, 4096]

    rows = []
    # Dense first: the 1M sparse scipy oracle is the sweep's long pole,
    # and a timeout there must not cost the cheap dense cells.
    if only is None or "dense" in only:
        for n in dense_grid:
            cell = run_dense(n)
            rows.append(cell)
            print(json.dumps(cell), flush=True)
    if only is None or "sparse" in only:
        for n, k in sparse_grid:
            cell = run_sparse(n, k)
            rows.append(cell)
            print(json.dumps(cell), flush=True)
    if only is None or "rect" in only:
        for n, m, k in rect_grid:
            cell = run_sparse(n, k, m=m)
            rows.append(cell)
            print(json.dumps(cell), flush=True)

    print("\n| instance | nnz/row | ours | scipy | speedup |",
          file=sys.stderr)
    print("|---|---|---|---|---|", file=sys.stderr)
    for c in rows:
        name = (f"{c['n']:,} x {c['n']:,} dense" if c["kind"] == "dense"
                else f"{c['n']:,} x {c.get('m', c['n']):,} sparse")
        k = c.get("nnz_per_row", "dense")
        print(f"| {name} | {k} | {c['ours_s']} s | {c['scipy_s']} s "
              f"| **{c['speedup']}x** |", file=sys.stderr)


if __name__ == "__main__":
    main()
