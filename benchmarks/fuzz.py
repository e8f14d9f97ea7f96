"""Differential fuzzing vs the scipy oracles (SURVEY.md SS5.2 extended).

Randomized sweep over the whole public surface: modes (cpu / device /
hybrid / auto / sharded / overlapped / sharded_hybrid), engines (compact /
candidates), input forms (dense with -1 forbidden / COO), int and float
costs, min and max problems, rectangular shapes, warm-started re-solves,
and structurally infeasible instances (must raise InfeasibleError, never
hang).  Every failure prints a self-contained repro line (seed + scenario).

Runs on CPU with 8 virtual devices (same trick as tests/conftest.py) so it
needs no accelerator.  Shapes are drawn from a small pool so the jit cache stays
hot across iterations.

Usage:  python benchmarks/fuzz.py --iters 500 --seed 0

Keep --iters <= ~400 per process: each distinct scenario compiles a new
XLA program, and this box's vm.max_map_count (65530) caps how many mmap
regions one process can hold -- a single long run dies around ~800 cases
with LLVM 'Cannot allocate memory' while the machine has 100+ GB free.
Drive longer sweeps as seed-offset segments in fresh processes.
"""

import argparse
import os
import sys
import traceback

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sslap_tpu import AuctionSolver, InfeasibleError, hopcroft_solve  # noqa: E402
from tests.utils import (  # noqa: E402
    random_sparse_instance,
    scipy_dense_objective,
    scipy_sparse_objective,
)

# Small pools keep the number of distinct jit shapes bounded.  256/512
# engage the deeper tier ladders (compact.default_tiers steps at powers
# of two; the 8-shard ladder only becomes multi-tier past ~512).
N_POOL = [1, 2, 3, 5, 8, 13, 16, 24, 32, 48, 64, 96, 128, 256, 512]
M_OFF_POOL = [0, 1, 4, 12]

# (mode, weight, square_only).  auto resolves to cpu below the crossover,
# which every pool size is, so it exercises the cpu routing + meta path.
MODES = [
    ("cpu", 4, False),
    ("device", 4, False),
    ("hybrid", 3, False),
    ("auto", 2, False),
    ("sharded", 2, False),
    ("overlapped", 1, True),
    ("sharded_hybrid", 1, True),
]


def pick_mode(rng, square):
    while True:
        modes, weights, sq = zip(*MODES)
        mode = rng.choice(modes, p=np.array(weights) / sum(weights))
        i = modes.index(mode)
        if sq[i] and not square:
            continue
        return mode


def one_case(seed):
    """Run one randomized scenario; returns (scenario_str, error_or_None)."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice(N_POOL))
    square = rng.random() < 0.7
    m = n if square else n + int(rng.choice(M_OFF_POOL))
    square = n == m
    density = float(rng.uniform(0.05, 1.0))
    integer = rng.random() < 0.7
    problem = "max" if rng.random() < 0.4 else "min"
    coo_input = rng.random() < 0.4
    mode = pick_mode(rng, square)
    # candidates is a single-device opt-in engine
    engine = ("candidates"
              if mode == "device" and square and rng.random() < 0.25
              else None)
    card = rng.random() < 0.3
    # every mode returns warm-startable 'prices' (round-3 contract)
    warm = rng.random() < 0.25
    # dense engine: square hybrid, no warm (it rejects warm_prices by
    # contract); auto-engine also reaches it implicitly on dense cases
    if (engine is None and mode == "hybrid" and square and not warm
            and rng.random() < 0.3):
        engine = "dense"
    infeasible = rng.random() < 0.10

    scen = (f"seed={seed} n={n} m={m} dens={density:.2f} "
            f"int={integer} prob={problem} coo={coo_input} mode={mode} "
            f"engine={engine} card={card} warm={warm} infeas={infeasible}")

    # Cost-regime pool: default; tiny alphabet (heavy ties stress the
    # deterministic tie-breaks and eviction chains); large-magnitude
    # floats (stress the eps schedule / f32 ULP accounting).
    reg = rng.random()
    if reg < 0.15:
        low, high = 1, 3
        scen += " ties"
    elif reg < 0.25 and not integer:
        low, high = 1e6, 1e7
        scen += " bigmag"
    else:
        low, high = 1, 1000
    loc, val, dense = random_sparse_instance(
        rng, n, m, density, low=low, high=high, integer=integer)

    if infeasible:
        # Structural infeasibility: pick a victim row and forbid all its
        # edges except collisions into one column already owned by another
        # row's ONLY edge -- simplest robust form: empty a row entirely is
        # rejected at ingest, so instead give k=2 rows the same single
        # column.
        if n < 2:
            infeasible = False
        else:
            col = int(loc[0, 1])
            keep = ~np.isin(loc[:, 0], [0, 1]) | (loc[:, 1] == col)
            loc2 = loc[keep]
            # make sure both rows still have their shared single column
            for r in (0, 1):
                if not ((loc2[:, 0] == r) & (loc2[:, 1] == col)).any():
                    loc2 = np.vstack([loc2, [[r, col]]])
            order = np.lexsort((loc2[:, 1], loc2[:, 0]))
            loc = loc2[order]
            val = (rng.integers(1, 1000, len(loc)) if integer
                   else rng.random(len(loc)) * 999 + 1)
            dense = np.full((n, m), -1.0)
            dense[loc[:, 0], loc[:, 1]] = val
            if integer:
                dense = dense.astype(np.int64)

    kwargs = dict(problem=problem, cardinality_check=card or infeasible,
                  mode=mode)
    if engine:
        kwargs["engine"] = engine
    if rng.random() < 0.10 and mode in ("cpu", "device", "hybrid"):
        kwargs["keep_assignment"] = False    # reference-style phase reset
        scen += " reset"
    if rng.random() < 0.10 and not coo_input:
        kwargs["pad_to"] = m                 # ELL width padding knob
        scen += " pad"
    use_config = rng.random() < 0.10
    if use_config:
        scen += " cfg"
    # solver-parameter jitter (small pools so jit caching stays effective)
    if rng.random() < 0.25:
        kwargs["theta"] = float(rng.choice([2.0, 5.0, 10.0]))
        scen += f" theta={kwargs['theta']}"
    if mode in ("hybrid", "sharded_hybrid") and rng.random() < 0.35:
        # round-4 window-gather rounds: forced ON at fuzz sizes (the
        # auto-gate would keep it off below 400k)
        kwargs["wide_rounds"] = True
        scen += " wide"
    valve = (not infeasible and mode == "device" and rng.random() < 0.05)
    if valve:
        kwargs["max_iter"] = 2
        scen += " valve"
    if use_config:
        # Same settings routed through the AuctionConfig bundle: kwargs
        # and config must be interchangeable (SURVEY.md SS6 config row).
        from sslap_tpu.config import AuctionConfig
        cfg = AuctionConfig(**{k: v for k, v in kwargs.items()
                               if k != "pad_to"})
        kwargs = ({"pad_to": kwargs["pad_to"]} if "pad_to" in kwargs
                  else {})
        kwargs["config"] = cfg
    if coo_input:
        solver = AuctionSolver(loc=loc, val=val, shape=(n, m), **kwargs)
    else:
        solver = AuctionSolver(dense, **kwargs)

    if infeasible:
        try:
            solver.solve()
            return scen, "expected InfeasibleError, got a solution"
        except InfeasibleError:
            return scen, None

    res = solver.solve()
    sol = np.asarray(res["sol"])
    meta = res["meta"]
    if valve and not meta["soln_found"]:
        # max_iter valve tripped before convergence: the contract is
        # soln_found=False + obj None, never a hang or bogus answer
        return scen, ("valve: obj not None" if meta["obj"] is not None
                      else None)
    if not meta["soln_found"]:
        return scen, f"soln_found False: {meta}"
    # valid injection over real edges
    if not ((sol >= 0).all() and len(set(sol.tolist())) == n):
        return scen, f"not an injection: {sol}"
    D = np.asarray(dense, np.float64)
    if (D[np.arange(n), sol] < 0).any():
        return scen, "assignment uses a forbidden edge"
    obj_check = D[np.arange(n), sol].sum()
    if abs(obj_check - meta["obj"]) > 1e-6 * max(1.0, abs(obj_check)):
        return scen, f"meta obj {meta['obj']} != recomputed {obj_check}"
    oracle = (scipy_dense_objective(dense, maximize=problem == "max")
              if not coo_input else
              scipy_sparse_objective(loc, val, n, m,
                                     maximize=problem == "max"))
    if integer:
        if meta["obj"] != oracle:
            return scen, f"int obj {meta['obj']} != oracle {oracle}"
    else:
        tol = (m + 1) * meta["final_eps"] + 1e-3
        if abs(meta["obj"] - oracle) > tol:
            return scen, (f"float obj {meta['obj']} vs oracle {oracle} "
                          f"beyond tol {tol}")

    if warm:
        prices = res.get("prices")
        if prices is None:
            return scen, "AuctionSolution missing warm-startable 'prices'"
        wkw = {}
        if mode in ("cpu", "hybrid") and rng.random() < 0.5:
            # round-5 FR family: the forward-reverse dual tightening must
            # never change the fixed point, warm-relax composition incl.
            wkw["warm_mode"] = "fr"
            if rng.random() < 0.3:
                wkw["warm_relax"] = float(rng.uniform(0.8, 1.0))
            scen += " fr"
        res2 = solver.solve(warm_prices=np.asarray(prices), **wkw)
        if integer and res2["meta"]["obj"] != oracle:
            return scen, (f"warm re-solve obj {res2['meta']['obj']} "
                          f"!= oracle {oracle}")
        if wkw and mode in ("cpu", "hybrid") and n == m and not integer:
            # churned-instance FR warm: drift values, re-solve warm from
            # the stale duals, check vs a fresh oracle
            val2 = (np.asarray(val, np.float64)
                    * rng.uniform(0.8, 1.25, len(val))).astype(np.float64)
            s3 = AuctionSolver(loc=loc, val=val2, shape=(n, m),
                               problem=problem, mode=mode,
                               cardinality_check=False)
            res3 = s3.solve(warm_prices=np.asarray(prices),
                            warm_mode="fr")
            if not res3["meta"]["soln_found"]:
                return scen, f"fr churn warm: soln_found False"
            orc3 = scipy_sparse_objective(loc, val2, n, m,
                                          maximize=problem == "max")
            tol3 = (m + 1) * res3["meta"]["final_eps"] + 1e-3
            if abs(res3["meta"]["obj"] - orc3) > tol3:
                return scen, (f"fr churn warm obj {res3['meta']['obj']} "
                              f"vs oracle {orc3} beyond {tol3}")
    return scen, None


def hk_case(seed):
    """Hopcroft-Karp vs scipy maximum_bipartite_matching: matching SIZE
    equality (matchings themselves may differ), validity of the returned
    matching, and the warm= path under pattern perturbation."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    rng = np.random.default_rng(seed)
    n = int(rng.choice(N_POOL))
    m = n + int(rng.choice(M_OFF_POOL))
    density = float(rng.uniform(0.02, 0.6))
    mask = rng.random((n, m)) < density   # NO planted matching: rows may
    scen = f"hk seed={seed} n={n} m={m} dens={density:.2f}"   # be empty
    rr, cc = np.nonzero(mask)
    if len(rr) == 0:
        return scen, None
    loc = np.stack([rr, cc], 1)

    match = hopcroft_solve(loc=loc, shape=(n, m))
    # validity: matched edges exist, columns unique
    mi = match >= 0
    if mi.any():
        if not mask[np.nonzero(mi)[0], match[mi]].all():
            return scen, "HK matched a non-edge"
        if len(set(match[mi].tolist())) != mi.sum():
            return scen, "HK matched a column twice"
    sp = csr_matrix((np.ones(len(rr), np.int8), (rr, cc)), shape=(n, m))
    oracle_sz = int((maximum_bipartite_matching(sp, perm_type="column")
                     >= 0).sum())
    if int(mi.sum()) != oracle_sz:
        return scen, f"HK size {mi.sum()} != scipy {oracle_sz}"

    # warm path: perturb ~10% of edges, seed with the stale matching
    keep = rng.random(len(rr)) > 0.1
    rr2, cc2 = rr[keep], cc[keep]
    add = rng.random((n, m)) < density * 0.1
    mask2 = np.zeros((n, m), bool)
    mask2[rr2, cc2] = True
    mask2 |= add
    rr3, cc3 = np.nonzero(mask2)
    if len(rr3) == 0:
        return scen, None
    loc3 = np.stack([rr3, cc3], 1)
    warm_match = hopcroft_solve(loc=loc3, shape=(n, m), warm=match)
    cold_match = hopcroft_solve(loc=loc3, shape=(n, m))
    wsz, csz = int((warm_match >= 0).sum()), int((cold_match >= 0).sum())
    if wsz != csz:
        return scen, f"warm HK size {wsz} != cold {csz}"
    wi = warm_match >= 0
    if wi.any():
        if not mask2[np.nonzero(wi)[0], warm_match[wi]].all():
            return scen, "warm HK matched a non-edge"
        if len(set(warm_match[wi].tolist())) != wi.sum():
            return scen, "warm HK matched a column twice"
    return scen, None


def batch_case(seed):
    """Batched solve (cpu / device / mesh-sharded) vs per-instance scipy."""
    from sslap_tpu.batch import auction_solve_batched, batch_from_dense

    rng = np.random.default_rng(seed)
    B = int(rng.choice([2, 3, 4, 8]))
    n = int(rng.choice([5, 8, 16, 24, 32]))
    m = n if rng.random() < 0.7 else n + 4
    density = float(rng.uniform(0.2, 1.0))
    integer = rng.random() < 0.7
    problem = "max" if rng.random() < 0.4 else "min"
    bmode = rng.choice(["cpu", "device", "mesh"], p=[0.4, 0.4, 0.2])
    scen = (f"batch seed={seed} B={B} n={n} m={m} dens={density:.2f} "
            f"int={integer} prob={problem} bmode={bmode}")

    mats = []
    for _ in range(B):
        _, _, dense = random_sparse_instance(
            rng, n, m, density, low=1, high=1000, integer=integer)
        mats.append(dense.astype(np.float64))
    batched = batch_from_dense(np.stack(mats))

    kw = dict(problem=problem)
    if bmode == "mesh":
        from jax.sharding import Mesh
        ndev = max(d for d in (8, 4, 2, 1) if B % d == 0)
        kw["mesh"] = Mesh(np.asarray(jax.devices()[:ndev]), ("batch",))
        kw["mode"] = "device"
    else:
        kw["mode"] = str(bmode)
    sols, metas = auction_solve_batched(batched, **kw)
    for b in range(B):
        sol = np.asarray(sols[b])
        D = mats[b]
        if not ((sol >= 0).all() and len(set(sol.tolist())) == n):
            return scen, f"inst {b}: not an injection"
        if (D[np.arange(n), sol] < 0).any():
            return scen, f"inst {b}: forbidden edge used"
        obj = D[np.arange(n), sol].sum()
        oracle = scipy_dense_objective(D, maximize=problem == "max")
        if integer:
            if obj != oracle:
                return scen, f"inst {b}: obj {obj} != oracle {oracle}"
        else:
            meta = metas[b] if isinstance(metas, (list, tuple)) else metas
            eps = meta.get("final_eps", 1e-3) if isinstance(meta, dict) \
                else 1e-3
            if abs(obj - oracle) > (m + 1) * eps + 1e-3:
                return scen, f"inst {b}: obj {obj} vs oracle {oracle}"
    return scen, None


def adapter_case(seed):
    """scipy-compatible linear_sum_assignment adapter: negatives allowed,
    maximize flag, tall (rows > cols) matrices via the transpose path."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    from sslap_tpu import linear_sum_assignment as our_lsa

    rng = np.random.default_rng(seed)
    n = int(rng.choice([3, 8, 16, 24, 32]))
    m = n + int(rng.choice([0, 0, 5, -2])) if n > 4 else n
    maximize = rng.random() < 0.5
    integer = rng.random() < 0.7
    scen = f"adapter seed={seed} n={n} m={m} max={maximize} int={integer}"
    if integer:
        C = rng.integers(-500, 500, (n, m)).astype(np.float64)
    else:
        C = rng.random((n, m)) * 200 - 100
    ri, ci = our_lsa(C, maximize=maximize)
    r0, c0 = scipy_lsa(C, maximize=maximize)
    ours, ref = C[ri, ci].sum(), C[r0, c0].sum()
    k = min(n, m)
    if len(ri) != k or len(set(zip(ri.tolist(), ci.tolist()))) != k:
        return scen, f"adapter returned {len(ri)} pairs, expected {k}"
    if integer:
        if ours != ref:
            return scen, f"adapter obj {ours} != scipy {ref}"
    elif abs(ours - ref) > 1e-2 * max(1.0, abs(ref)):
        return scen, f"adapter obj {ours} vs scipy {ref}"
    return scen, None


def sharded_flags_case(seed):
    """Sharded-hybrid driver flag matrix (overlap / ladder_balance / trunc /
    mesh width / warm prices) vs the scipy oracle."""
    from jax.sharding import Mesh

    from sslap_tpu.parallel.sharded_compact import (
        auction_solve_sharded_hybrid,
    )

    rng = np.random.default_rng(seed)
    n = int(rng.choice([16, 32, 64, 96, 128, 512, 1024]))
    density = (float(rng.uniform(0.1, 0.8)) if n <= 128
               else float(rng.uniform(0.01, 0.05)))
    integer = rng.random() < 0.7
    problem = "max" if rng.random() < 0.4 else "min"
    ndev = int(rng.choice([1, 2, 4, 8]))
    overlap = rng.random() < 0.4
    balance = rng.random() < 0.4
    wide = rng.random() < 0.4          # round-4 window-gather rounds
    trunc = int(rng.choice([0, 4, 64, 256]))
    scen = (f"shflags seed={seed} n={n} dens={density:.2f} int={integer} "
            f"prob={problem} d={ndev} ov={overlap} bal={balance} "
            f"wide={wide} trunc={trunc}")

    loc, val, dense = random_sparse_instance(
        rng, n, n, density, low=1, high=1000, integer=integer)
    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("rows",))
    res = auction_solve_sharded_hybrid(
        dense, mesh=mesh, problem=problem, cardinality_check=False,
        trunc=trunc, overlap=overlap, ladder_balance=balance,
        wide_rounds=wide,
        balance_floor=int(rng.choice([8, 64, 256])))
    sol = np.asarray(res["sol"])
    meta = res["meta"]
    if not meta["soln_found"]:
        return scen, f"soln_found False: {meta}"
    if not ((sol >= 0).all() and len(set(sol.tolist())) == n):
        return scen, "not an injection"
    D = np.asarray(dense, np.float64)
    if (D[np.arange(n), sol] < 0).any():
        return scen, "forbidden edge used"
    obj = D[np.arange(n), sol].sum()
    oracle = scipy_dense_objective(dense, maximize=problem == "max")
    if integer:
        if obj != oracle:
            return scen, f"obj {obj} != oracle {oracle}"
    elif abs(obj - oracle) > (n + 1) * meta["final_eps"] + 1e-3:
        return scen, f"obj {obj} vs oracle {oracle}"

    # warm re-solve through the same driver must stay optimal
    if rng.random() < 0.3 and res.get("prices") is not None:
        res2 = auction_solve_sharded_hybrid(
            dense, mesh=mesh, problem=problem, cardinality_check=False,
            trunc=trunc, overlap=overlap, ladder_balance=balance,
            warm_prices=np.asarray(res["prices"]))
        sol2 = np.asarray(res2["sol"])
        obj2 = D[np.arange(n), sol2].sum()
        if integer and obj2 != oracle:
            return scen, f"warm obj {obj2} != oracle {oracle}"
    return scen, None


FAMILIES = {"auction": one_case, "hk": hk_case, "batch": batch_case,
            "adapter": adapter_case, "sharded_flags": sharded_flags_case}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", choices=[*FAMILIES, "all"], default="auction")
    ap.add_argument("--progress-every", type=int, default=25)
    args = ap.parse_args()

    if args.family == "all":
        fams = list(FAMILIES.values())
    else:
        fams = [FAMILIES[args.family]]

    failures = []
    for i in range(args.iters):
        seed = args.seed + i
        case = fams[i % len(fams)]
        try:
            scen, err = case(seed)
        except Exception:
            scen = f"seed={seed} fam={case.__name__} (exception during case)"
            err = traceback.format_exc(limit=12)
        if err:
            failures.append((scen, err))
            print(f"FAIL {scen}\n  {err}", flush=True)
        if (i + 1) % args.progress_every == 0:
            print(f"[{i + 1}/{args.iters}] failures={len(failures)}",
                  flush=True)

    print(f"done: {args.iters} cases, {len(failures)} failures", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
