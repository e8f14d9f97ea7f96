"""Single-instance dense engine (engine='dense'): the batched dense-chunk
hybrid (dense_batch.py) serving B=1 through the public API.

Why it exists: a fully dense cost matrix through the ELL path pays one
random price gather per entry; the dense formulation streams contiguous
[C, m] rows instead.
"""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from sslap_tpu import AuctionSolver, auction_solve
from sslap_tpu.config import AuctionConfig


def dense_instance(n, seed=0, forbidden_frac=0.0):
    rng = np.random.default_rng(seed)
    C = rng.integers(1, 1000, (n, n)).astype(np.float32)
    if forbidden_frac:
        mask = rng.random((n, n)) < forbidden_frac
        np.fill_diagonal(mask, False)        # keep it feasible
        C = np.where(mask, -1.0, C)
    return C


def scipy_obj(C):
    A = np.where(C < 0, np.inf, C.astype(np.float64))
    r, c = linear_sum_assignment(A)
    return float(C.astype(np.float64)[r, c].sum())


def test_dense_engine_exact_vs_scipy():
    C = dense_instance(96)
    res = auction_solve(C, mode="hybrid", engine="dense")
    assert res["meta"]["soln_found"]
    assert res["meta"]["mode"] == "hybrid"
    assert res["meta"]["engine"] == "dense"
    assert res["meta"]["obj"] == scipy_obj(C)


def test_dense_engine_long_tail_within_budget():
    # A 2048^2 integer instance whose eps_min host tail needs ~1.32M bids:
    # the dense engine's tail budget used to be 100n + 1M (~1.2M here),
    # so a feasible instance came back soln_found=False.
    from sslap_tpu.hybrid import native_available
    if not native_available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0)
    rng.integers(1, 1000, (256, 256))
    C = rng.integers(1, 1000, (2048, 2048))
    res = auction_solve(C, mode="hybrid", engine="dense",
                        cardinality_check=False)
    assert res["meta"]["soln_found"]
    assert res["meta"]["host_bids"] > 100 * 2048 + 1_000_000
    r, c = linear_sum_assignment(C)
    assert res["meta"]["obj"] == int(C[r, c].sum())


def test_dense_engine_forbidden_entries():
    C = dense_instance(64, seed=3, forbidden_frac=0.3)
    res = auction_solve(C, mode="hybrid", engine="dense")
    assert res["meta"]["soln_found"]
    assert res["meta"]["obj"] == scipy_obj(C)
    sol = res["sol"]
    assert (C[np.arange(64), sol] >= 0).all()


def test_dense_engine_max_problem():
    C = dense_instance(48, seed=5)
    res = auction_solve(C, mode="hybrid", engine="dense", problem="max")
    A = C.astype(np.float64)
    r, c = linear_sum_assignment(A, maximize=True)
    assert res["meta"]["obj"] == float(A[r, c].sum())


def test_auto_engine_picks_dense_for_dense_hybrid():
    C = dense_instance(64, seed=7)
    s = AuctionSolver(C, mode="hybrid")          # engine='auto'
    res = s.solve()
    assert res["meta"]["engine"] == "dense"
    assert res["meta"]["obj"] == scipy_obj(C)
    # prices exposed like every other mode
    assert s.prices is not None and s.prices.shape == (64,)


def test_auto_engine_keeps_compact_for_sparse():
    rng = np.random.default_rng(11)
    n = 64
    C = np.full((n, n), -1.0)
    C[np.arange(n), rng.permutation(n)] = 5.0
    C[np.arange(n), np.arange(n)] = rng.integers(1, 9, n).astype(float)
    s = AuctionSolver(C, mode="hybrid")
    res = s.solve()
    assert res["meta"].get("engine") != "dense"
    assert res["meta"]["soln_found"]


def test_dense_engine_requires_hybrid_mode():
    C = dense_instance(32)
    with pytest.raises(ValueError, match="mode='hybrid'"):
        auction_solve(C, mode="device", engine="dense")
    with pytest.raises(ValueError, match="mode='hybrid'"):
        auction_solve(C, mode="cpu", engine="dense")


def test_dense_engine_rejects_warm_prices():
    C = dense_instance(32)
    s = AuctionSolver(C, mode="hybrid", engine="dense")
    with pytest.raises(ValueError, match="warm_prices"):
        s.solve(warm_prices=np.zeros(32, np.float32))


def test_dense_engine_via_config_bundle():
    C = dense_instance(48, seed=9)
    cfg = AuctionConfig(mode="hybrid", engine="dense")
    res = auction_solve(C, config=cfg)
    assert res["meta"]["mode"] == "hybrid"
    assert res["meta"]["engine"] == "dense"
    assert res["meta"]["obj"] == scipy_obj(C)


def test_dense_engine_serving_cache():
    """Construct-once parity (PERF.md round-3 dense A/B: ~26 s/call went to
    re-shipping the dense tensor each solve): the second solve() on the
    same AuctionSolver reuses the device-resident arrays and the host CSR,
    and returns the identical assignment."""
    C = dense_instance(64, seed=3)
    s = AuctionSolver(C, mode="hybrid", engine="dense")
    r1 = s.solve()
    assert "dense_dev" in s._device_cache and "dense_csr" in s._device_cache
    dev_before = s._device_cache["dense_dev"]
    r2 = s.solve()
    assert s._device_cache["dense_dev"] is dev_before    # reused, not rebuilt
    np.testing.assert_array_equal(r1.sol, r2.sol)
    assert r2["meta"]["obj"] == scipy_obj(C)
