"""Public API surface tests (T10): the scipy adapter, AuctionSolver
object workflow, kwargs validation, and solution metadata contract."""

import numpy as np
import pytest

from sslap_tpu import (
    AuctionSolver,
    InfeasibleError,
    auction_solve,
    hopcroft_solve,
    linear_sum_assignment,
)


def test_scipy_adapter_matches_scipy():
    from scipy.optimize import linear_sum_assignment as scipy_lsa
    rng = np.random.default_rng(2)
    C = rng.random((24, 24)) * 10 - 3          # negatives allowed here
    tol = 1.0  # float path is eps-optimal within ~m * eps_min (~1 here)
    r, c = linear_sum_assignment(C)
    rs, cs = scipy_lsa(C)
    assert abs(C[r, c].sum() - C[rs, cs].sum()) <= tol
    r, c = linear_sum_assignment(C, maximize=True)
    rs, cs = scipy_lsa(C, maximize=True)
    assert abs(C[r, c].sum() - C[rs, cs].sum()) <= tol


def test_solver_object_exposes_prices_and_meta():
    rng = np.random.default_rng(3)
    C = rng.integers(1, 50, (16, 16))
    s = AuctionSolver(C)
    res = s.solve()
    assert s.prices is not None and s.prices.shape == (16,)
    assert s.meta is res["meta"]
    for key in ("obj", "its", "phases", "soln_found", "final_eps",
                "unassigned", "time"):
        assert key in res["meta"], key
    # warm start from own prices converges to the same optimum
    res2 = s.solve(warm_prices=s.prices)
    assert res2["meta"]["obj"] == res["meta"]["obj"]


def test_kwargs_validation():
    C = np.ones((4, 4))
    with pytest.raises(ValueError):
        auction_solve(C, problem="maximize")       # bad problem name
    with pytest.raises(ValueError):
        auction_solve(C, mode="gpu")               # bad mode
    with pytest.raises(ValueError):
        auction_solve(np.ones((4, 2)))             # rows > cols
    with pytest.raises(ValueError):
        auction_solve()                            # no input
    with pytest.raises(ValueError):
        auction_solve(C, loc=np.zeros((1, 2), np.int64),
                      val=np.ones(1))              # both inputs


def test_max_iter_valve_on_infeasible():
    """cardinality_check=False on an infeasible instance must terminate via
    max_iter with soln_found=False, never hang (SURVEY.md SS1 item 5)."""
    C = np.array([[5., -1, -1],
                  [7., -1, -1],
                  [1., 2., -1]])
    res = auction_solve(C, cardinality_check=False, max_iter=500)
    assert not res["meta"]["soln_found"]
    assert res["meta"]["unassigned"] >= 1


def test_hopcroft_standalone_rectangular():
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching
    rng = np.random.default_rng(5)
    n, m = 20, 30
    mask = rng.random((n, m)) < 0.15
    loc = np.stack(np.nonzero(mask), 1).astype(np.int64)
    match = hopcroft_solve(loc=loc, shape=(n, m))
    size = int((match >= 0).sum())
    sp = csr_matrix((np.ones(len(loc)), (loc[:, 0], loc[:, 1])),
                    shape=(n, m))
    ref = maximum_bipartite_matching(sp, perm_type="column")
    assert size == int((ref >= 0).sum())
    # validity: matched columns unique and edges exist
    mm = match[match >= 0]
    assert len(set(mm.tolist())) == len(mm)
    for i, j in enumerate(match):
        if j >= 0:
            assert mask[i, j]


def test_auction_config_applies_and_overrides():
    from sslap_tpu import AuctionConfig
    rng = np.random.default_rng(6)
    C = rng.integers(1, 30, (12, 12))
    cfg = AuctionConfig(problem="max", theta=10.0, mode="device",
                        cardinality_check=False)
    res = auction_solve(C, config=cfg)
    from scipy.optimize import linear_sum_assignment as scipy_lsa
    r, c = scipy_lsa(C, maximize=True)
    assert res["meta"]["obj"] == int(C[r, c].sum())
    # explicit kwarg beats the config
    res2 = auction_solve(C, config=cfg, problem="min")
    r, c = scipy_lsa(C)
    assert res2["meta"]["obj"] == int(C[r, c].sum())
    with pytest.raises(ValueError):
        AuctionConfig(theta=0.5)
    with pytest.raises(ValueError):
        AuctionConfig(mode="gpu")


def test_warm_relax_price_rollback():
    # warm_relax scales warm duals down to restore slack for
    # pattern-churned re-solves (round 4); must stay exact and reject
    # out-of-range factors.
    import numpy as np
    from scipy.optimize import linear_sum_assignment
    from sslap_tpu import AuctionSolver

    rng = np.random.default_rng(3)
    C = rng.integers(1, 100, (64, 64))
    s = AuctionSolver(C, cardinality_check=False)
    r1 = s.solve()
    rr, cc = linear_sum_assignment(C)
    oracle = int(C[rr, cc].sum())
    assert r1["meta"]["obj"] == oracle
    r2 = s.solve(warm_prices=r1["prices"], warm_relax=0.9)
    assert r2["meta"]["obj"] == oracle
    with pytest.raises(ValueError):
        s.solve(warm_prices=r1["prices"], warm_relax=0.0)
    with pytest.raises(ValueError):
        s.solve(warm_prices=r1["prices"], warm_relax=1.5)


@pytest.mark.parametrize("case", ["at_crossover", "below_crossover",
                                  "no_native", "float64"])
def test_auto_mode_routing(case, monkeypatch):
    import sslap_tpu.api as api
    from sslap_tpu import hybrid as H
    rng = np.random.default_rng(0)
    C = rng.integers(1, 100, (32, 32)).astype(
        np.float64 if case == "float64" else np.int64)
    solver = AuctionSolver(C, cardinality_check=False,
                           dtype=np.float64 if case == "float64" else None)
    crossover = {"at_crossover": 32}.get(case, 33)
    monkeypatch.setattr(api, "DEFAULT_CROSSOVER", crossover)
    if case == "no_native":
        monkeypatch.setattr(H, "native_available", lambda: False)
    expect = {"at_crossover": "hybrid", "below_crossover": "cpu",
              "no_native": "device", "float64": "cpu"}[case]
    assert solver._resolve_mode() == expect


def test_hybrid_device_error_propagates(monkeypatch):
    """A device failure in the hybrid pass raises; nothing re-solves on
    the CPU behind the caller's back."""
    import jax
    from sslap_tpu import hybrid as H
    calls = []

    def boom(*a, **kw):
        calls.append(kw.get("mode"))
        raise jax.errors.JaxRuntimeError("device lost")

    monkeypatch.setattr(H, "solve_hybrid", boom)
    rng = np.random.default_rng(1)
    C = rng.integers(1, 100, (16, 16))
    with pytest.raises(jax.errors.JaxRuntimeError, match="device lost"):
        AuctionSolver(C, mode="hybrid", engine="compact",
                      cardinality_check=False).solve()
    assert calls == ["hybrid"]
