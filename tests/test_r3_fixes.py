"""Round-3 advisor/verdict fixes (ADVICE.md round 2, VERDICT.md task 7):
distributed-mode config parity, float64 mode guard, sharded warm-start +
returned prices, overlapped instrumentation, candidate tie-break contract.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sslap_tpu import AuctionSolver, auction_solve
from sslap_tpu.config import AuctionConfig
from tests.utils import random_sparse_instance


def test_config_accepts_distributed_modes():
    for mode in ("sharded", "overlapped"):
        cfg = AuctionConfig(mode=mode)
        assert cfg.mode == mode


def test_config_mode_matches_solver_whitelist():
    rng = np.random.default_rng(0)
    C = rng.integers(1, 50, (16, 16))
    cfg = AuctionConfig(mode="sharded")
    res = auction_solve(C, config=cfg, cardinality_check=False)
    assert res["meta"]["soln_found"]
    assert res["meta"]["n_shards"] >= 1


def test_float64_rejects_distributed_modes():
    rng = np.random.default_rng(1)
    C = rng.random((12, 12)).astype(np.float64)
    for mode in ("sharded", "overlapped"):
        with pytest.raises(ValueError, match="float64"):
            AuctionSolver(C, mode=mode, dtype=np.float64,
                          cardinality_check=False).solve()


@pytest.mark.parametrize("mode", ["sharded", "overlapped"])
def test_distributed_warm_prices_and_returned_prices(mode):
    rng = np.random.default_rng(2)
    n = 48
    loc, val, _ = random_sparse_instance(rng, n, n, 0.2, integer=True)
    solver = AuctionSolver(loc=loc, val=val, shape=(n, n), mode=mode,
                          cardinality_check=False)
    res1 = solver.solve()
    assert res1["meta"]["soln_found"]
    assert solver.prices is not None and solver.prices.shape == (n,)
    # Warm-started re-solve: prices seed the next solve (correctness is
    # the contract: monotone prices keep eps-CS arguments intact).
    res2 = solver.solve(warm_prices=solver.prices)
    assert res2["meta"]["obj"] == res1["meta"]["obj"]
    assert res2["meta"]["soln_found"]


def test_overlapped_instrument_keys():
    from sslap_tpu.parallel.overlap import auction_solve_overlapped
    rng = np.random.default_rng(3)
    n = 32
    loc, val, _ = random_sparse_instance(rng, n, n, 0.25, integer=True)
    res = auction_solve_overlapped(loc=loc, val=val, shape=(n, n),
                                   cardinality_check=False, instrument=True)
    meta = res["meta"]
    for k in ("round_s", "compute_s", "comm_s", "comm_fraction"):
        assert k in meta and meta[k] >= 0.0


def test_warm_prices_shape_validated():
    # A mis-shaped warm_prices must raise a clear ValueError at the API
    # boundary on every entry point, not an opaque jit shape error.
    import jax
    from jax.sharding import Mesh

    from sslap_tpu import AuctionSolver
    from sslap_tpu.parallel import (
        auction_solve_overlapped,
        auction_solve_sharded,
        auction_solve_sharded_hybrid,
    )

    rng = np.random.default_rng(0)
    C = rng.integers(1, 100, (16, 16))
    bad = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="warm_prices"):
        AuctionSolver(C, mode="cpu", cardinality_check=False).solve(
            warm_prices=bad)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("rows",))
    for fn in (auction_solve_sharded, auction_solve_overlapped,
               auction_solve_sharded_hybrid):
        with pytest.raises(ValueError, match="warm_prices"):
            fn(C, mesh=mesh, cardinality_check=False, warm_prices=bad)


@pytest.mark.parametrize("mode", ["cpu", "device", "hybrid", "sharded",
                                  "overlapped", "sharded_hybrid"])
def test_prices_key_on_every_mode(mode):
    # Contract: every AuctionSolution carries 'prices' (transformed-space
    # duals) reusable as warm_prices= -- the cpu/device/hybrid returns used
    # to omit the key, silently breaking res['prices'] round-trips that
    # worked on the distributed modes.
    rng = np.random.default_rng(3)
    C = rng.integers(1, 100, (24, 24))
    solver = AuctionSolver(C, mode=mode, cardinality_check=False)
    res = solver.solve()
    assert res["prices"] is not None
    assert np.asarray(res["prices"]).shape == (24,)
    res2 = solver.solve(warm_prices=np.asarray(res["prices"]))
    assert res2["meta"]["obj"] == res["meta"]["obj"]


def test_rect_hybrid_max_iter_trip_not_reported_optimal():
    # The rectangular per-phase hybrid used to report soln_found=True when
    # max_iter tripped after a COMPLETED GS phase at eps > eps_min -- a
    # complete but only eps-CS-at-larger-eps assignment.  Same standard as
    # the square fast path now: optimality requires reaching eps_min.
    from sslap_tpu import ingest
    from sslap_tpu.hybrid import solve_hybrid

    rng = np.random.default_rng(5)
    C = rng.integers(1, 1000, (8, 12)).astype(np.float64)
    prob = ingest.from_dense(C)
    # threshold=0 makes the device phase run to completion, so max_iter=1
    # genuinely trips after the first phase's GS completes at eps0 >> eps_min
    sigma, _, meta = solve_hybrid(prob, mode="hybrid", threshold=0,
                                  max_iter=1)
    assert meta["unassigned"] == 0          # assignment IS complete...
    assert meta["final_eps"] > 1.0 / 13     # ...but only eps0-CS
    assert not meta["soln_found"]           # so it must not read optimal


def test_candidate_fast_bid_tie_breaks_lowest_column():
    # Shortlist slots ordered by build-time w (col 7 first), but at bid
    # time both entries tie: the bid must target the LOWER column (3),
    # matching the compact engine's documented tie-break.
    from sslap_tpu.candidate import _fast_bids, build_scpack
    dtype = jnp.float32
    kappa = 2
    sc_cols = jnp.asarray([[7, 3]], jnp.int32)
    sc_vals = jnp.asarray([[5.0, 5.0]], dtype)
    from sslap_tpu.auction import neg_sentinel
    tau = jnp.full((1,), neg_sentinel(dtype))       # certified
    nv = jnp.asarray([2], jnp.int32)
    scpack = build_scpack(sc_cols, sc_vals, tau, nv, kappa)
    tgt, bid, uncert, viol = _fast_bids(
        scpack, jnp.zeros((16,), dtype), jnp.full((1,), -1, jnp.int32),
        jnp.ones((1,), bool), jnp.asarray(0.5, dtype),
        jnp.asarray(10.0, dtype), kappa, dtype, 16, False)
    assert int(tgt[0]) == 3
    assert not bool(uncert[0])


def test_hopcroft_warm_seed_matches_cold():
    # VERDICT round-2 task 8: warm-seeded HK (tracking workloads).  A
    # stale matching -- some edges vanished, one column claimed twice --
    # must be sanitized into a valid seed and still yield a maximum
    # matching of the same size as the cold solve.
    from sslap_tpu import hopcroft_solve
    rng = np.random.default_rng(42)
    n = 300
    loc, val, _ = random_sparse_instance(rng, n, n, 6)
    cold = hopcroft_solve(loc=loc, val=val, shape=(n, n))
    size_cold = int((cold >= 0).sum())

    stale = cold.copy()
    stale[0] = n - 1 if cold[0] != n - 1 else n - 2   # likely absent edge
    stale[1] = stale[2]                               # duplicate column
    warm = hopcroft_solve(loc=loc, val=val, shape=(n, n), warm=stale)
    assert int((warm >= 0).sum()) == size_cold
    # result is a real matching over existing edges
    got = warm[warm >= 0]
    assert len(np.unique(got)) == len(got)
    edge_set = {(int(r), int(c)) for r, c in loc}
    for r, c in enumerate(warm):
        if c >= 0:
            assert (r, int(c)) in edge_set


def test_sanitize_matching_drops_stale_and_duplicates():
    from sslap_tpu import ingest
    from sslap_tpu.feasibility import sanitize_matching
    # pattern: row0 -> {0,1}, row1 -> {1}, row2 -> {2}
    loc = np.array([[0, 0], [0, 1], [1, 1], [2, 2]])
    val = np.ones(4)
    prob = ingest.from_coo(loc, val, shape=(3, 4))
    # row0 claims col 3 (absent edge), rows 1+2 both claim col 1 (dup;
    # row2's claim is also an absent edge so it is dropped twice over)
    mr, mc = sanitize_matching(prob, np.array([3, 1, 1]))
    assert mr.tolist() == [-1, 1, -1]
    assert mc.tolist() == [-1, 1, -1, -1]
    with pytest.raises(ValueError, match="length"):
        sanitize_matching(prob, np.array([0, 1]))


def test_sharded_backends_reject_f64_and_int_exact():
    # A silent f32 downcast on device would corrupt costs above 2**24;
    # both distributed full-width backends must refuse what the sharded
    # hybrid already refuses (api._resolve_mode guards the one-flag path,
    # these are the direct entry points).
    from sslap_tpu.parallel import (auction_solve_overlapped,
                                    auction_solve_sharded)
    rng = np.random.default_rng(3)
    C = rng.random((16, 16)) + 1.0
    big = rng.integers(2 ** 28, 2 ** 30, (16, 16))   # ingest -> int_exact
    for fn in (auction_solve_sharded, auction_solve_overlapped):
        with pytest.raises(ValueError, match="float64"):
            fn(C, dtype=np.float64, cardinality_check=False)
        with pytest.raises(ValueError, match="float64"):
            fn(big, cardinality_check=False)


def test_distributed_meta_mode_key_and_problem_passthrough():
    from sslap_tpu import AuctionSolver
    rng = np.random.default_rng(4)
    C = rng.integers(1, 100, (32, 32))
    for mode in ("sharded", "overlapped", "sharded_hybrid"):
        res = AuctionSolver(C, mode=mode, cardinality_check=False).solve()
        assert res["meta"]["mode"] == mode
        assert res["meta"]["soln_found"]
