"""Checkpoint/warm-start and observability subsystem tests (SURVEY.md SS6)."""

import numpy as np
import jax.numpy as jnp

from sslap_tpu import AuctionSolver, auction_solve, ingest
from sslap_tpu import auction as _auction
from sslap_tpu.utils import load_state, save_state
from sslap_tpu.utils.profiling import throughput_counters


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    C = rng.integers(0, 100, (24, 24))
    s = AuctionSolver(C)
    res = s.solve()
    p = tmp_path / "state.npz"
    save_state(p, s.prices, eps=res["meta"]["final_eps"],
               rounds=res["meta"]["its"], extra={"tag": "t"})
    prices, meta = load_state(p)
    np.testing.assert_array_equal(prices, s.prices)
    assert meta["eps"] == res["meta"]["final_eps"]
    assert meta["extra"]["tag"] == "t"
    # restored prices warm-start to the same optimum
    res2 = s.solve(warm_prices=prices)
    assert res2["meta"]["obj"] == res["meta"]["obj"]


def test_on_round_callback():
    rng = np.random.default_rng(1)
    C = rng.integers(0, 50, (16, 16))
    prob = ingest.from_dense(C)
    tr = _auction.make_transform("min", prob.m, np.int32, float(C.max()))
    seen = []

    def on_round(r, unassigned, eps):
        seen.append((int(r), int(unassigned), float(eps)))

    res = _auction.solve_ell(
        prob.cols, tr.apply(prob.vals), prob.valid, prob.nvalid,
        jnp.zeros((prob.m,), jnp.int32),
        eps0=500, eps_min=1, theta=5, max_iter=10_000,
        on_round=on_round)
    import jax
    jax.effects_barrier()
    assert len(seen) == int(np.asarray(res.rounds))
    # rounds strictly increase; final round fully assigned
    rounds = [s[0] for s in seen]
    assert rounds == sorted(rounds)
    assert seen[-1][1] == 0


def test_throughput_counters():
    c = throughput_counters(1000, {"time": 2.0, "its": 10})
    assert c["nnz_per_s"] == 5000.0
    assert c["rounds_per_s"] == 5.0


def test_compile_cache_uses_env_dir_and_sets_nothing(monkeypatch):
    import jax
    from sslap_tpu.utils import enable_compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert enable_compile_cache() == "/some/cache"
    assert calls == []


def test_compile_cache_defaults_to_checkout_dir(monkeypatch):
    import os
    import jax
    from sslap_tpu.utils import enable_compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls


def test_native_so_name_keys_on_flags_and_host():
    from sslap_tpu.native import build
    src = b"int f() { return 1; }"
    base = build.so_name(src, host="x86_64\nflags: avx2")
    assert base == build.so_name(src, host="x86_64\nflags: avx2")
    assert base != build.so_name(src + b" ", host="x86_64\nflags: avx2")
    assert base != build.so_name(src, host="x86_64\nflags: avx512f")
    assert base != build.so_name(src, flags=("-O2",),
                                 host="x86_64\nflags: avx2")
    assert build.so_name(src) == build.so_name(src, host=build.host_cpu_tag())
