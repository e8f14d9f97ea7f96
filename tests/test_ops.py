"""Device round pieces against plain numpy references (SURVEY.md SS5.2
'unit'): the bid top-2, the conflict-resolving reduction and a full
Jacobi round, the native Gauss-Seidel engine against the pure-numpy one,
and the window-gather wide round against the scalar gather."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sslap_tpu import auction as A


def _random_problem(rng, n, m, K, single_entry_rows=True):
    cols = rng.integers(0, m, (n, K)).astype(np.int32)
    vals = (rng.random((n, K)) * 100).astype(np.float32)
    valid = rng.random((n, K)) < 0.7
    valid[:, 0] = True  # no empty rows
    if single_entry_rows:
        valid[0, 1:] = False  # exercise the v2 = v1 - bigp branch
    # within-row sorted unique columns (the ingest invariant)
    for i in range(n):
        c = np.unique(cols[i][valid[i]])
        valid[i] = False
        valid[i, :len(c)] = True
        cols[i, :len(c)] = c
    nvalid = valid.sum(1).astype(np.int32)
    return cols, vals, valid, nvalid


def _np_bids(cols, vals, valid, nvalid, prices, sigma, eps, bigp):
    """Row-by-row top-2 bid: lowest-column argmax, v2 = v1 - bigp for
    single-entry rows, m for rows that do not bid."""
    n = cols.shape[0]
    m = prices.shape[0]
    tgt = np.full(n, m, np.int32)
    bid = np.zeros(n, np.float32)
    for i in range(n):
        if sigma[i] >= 0 or nvalid[i] == 0:
            continue
        c = cols[i][valid[i]]
        w = vals[i][valid[i]] - prices[c]
        k = int(np.argmax(w))               # columns ascending: lowest wins
        v1 = w[k]
        v2 = np.delete(w, k).max() if w.size >= 2 else v1 - np.float32(bigp)
        tgt[i] = c[k]
        bid[i] = vals[i][valid[i]][k] - v2 + np.float32(eps)
    return tgt, bid


@pytest.mark.parametrize("case", ["single_entry_rows", "ties",
                                  "non_bidders"])
def test_compute_bids_matches_numpy(case):
    rng = np.random.default_rng({"single_entry_rows": 0, "ties": 1,
                                 "non_bidders": 2}[case])
    n, m, K = 96, 128, 6
    cols, vals, valid, nvalid = _random_problem(
        rng, n, m, K, single_entry_rows=case == "single_entry_rows")
    prices = (rng.random(m) * 10).astype(np.float32)
    sigma = np.full(n, -1, np.int32)
    if case == "ties":
        # integer-valued w with many equal maxima inside a row
        vals = rng.integers(0, 3, (n, K)).astype(np.float32)
        prices = np.zeros(m, np.float32)
    if case == "non_bidders":
        sigma = np.where(rng.random(n) < 0.4, 1, -1).astype(np.int32)
        nvalid[5] = 0
        valid[5] = False
    eps, bigp = np.float32(0.25), np.float32(101.0)
    tgt, bid = A.compute_bids(jnp.asarray(cols), jnp.asarray(vals),
                              jnp.asarray(valid), jnp.asarray(nvalid),
                              jnp.asarray(prices), jnp.asarray(sigma),
                              jnp.float32(eps), jnp.float32(bigp))
    rt, rb = _np_bids(cols, vals, valid, nvalid, prices, sigma, eps, bigp)
    np.testing.assert_array_equal(np.asarray(tgt), rt)
    mask = rt < m
    np.testing.assert_allclose(np.asarray(bid)[mask], rb[mask], rtol=1e-6)


def _np_resolve(tgt, bid, m, rows):
    """Per column: highest bid wins, ties to the lowest row id; columns
    without a bid keep (neg, I32_MAX)."""
    neg = float(A.neg_sentinel_value(np.float32))
    best = np.full(m, neg, np.float32)
    winner = np.full(m, 2 ** 31 - 1, np.int64)
    for t, b, r in zip(tgt, bid, rows):
        if t >= m:
            continue
        if b > best[t] or (b == best[t] and r < winner[t]):
            best[t], winner[t] = b, r
    return best, winner


@pytest.mark.parametrize("seed", [7, 8])
def test_resolve_bids_matches_numpy_with_ties(seed):
    rng = np.random.default_rng(seed)
    nb, m = 64, 32
    tgt = rng.integers(0, m + 1, nb).astype(np.int32)   # m = no bid
    bid = rng.integers(0, 5, nb).astype(np.float32)     # deliberate ties
    rows = rng.permutation(1000)[:nb].astype(np.int32)  # global row ids
    best, winner = A.resolve_bids(jnp.asarray(tgt), jnp.asarray(bid), m,
                                  jnp.asarray(rows))
    rb, rw = _np_resolve(tgt, bid, m, rows)
    np.testing.assert_array_equal(np.asarray(winner), rw)
    np.testing.assert_array_equal(np.asarray(best), rb)
    assert (tgt == m).any() and len(set(tgt.tolist())) < nb


def test_jacobi_round_matches_numpy_round():
    rng = np.random.default_rng(3)
    n = m = 64
    K = 5
    cols, vals, valid, nvalid = _random_problem(rng, n, m, K)
    prices = (rng.random(m) * 5).astype(np.float32)
    owner = np.full(m, -1, np.int32)
    sigma = np.full(n, -1, np.int32)
    # a few rows already assigned, so evictions happen
    for i, j in ((1, int(cols[1, 0])), (2, int(cols[2, 0]))):
        if owner[j] < 0:
            owner[j], sigma[i] = i, j
    eps, bigp = np.float32(1.0), np.float32(101.0)
    got = A.jacobi_round(jnp.asarray(cols), jnp.asarray(vals),
                         jnp.asarray(valid), jnp.asarray(nvalid),
                         jnp.asarray(prices), jnp.asarray(owner),
                         jnp.asarray(sigma), jnp.float32(eps),
                         jnp.float32(bigp))
    tgt, bid = _np_bids(cols, vals, valid, nvalid, prices, sigma, eps, bigp)
    best, winner = _np_resolve(tgt, bid, m, np.arange(n))
    p2, o2, s2 = prices.copy(), owner.copy(), sigma.copy()
    for j in range(m):
        if winner[j] < n:
            if o2[j] >= 0:
                s2[o2[j]] = -1
            p2[j], o2[j], s2[winner[j]] = best[j], winner[j], j
    np.testing.assert_allclose(np.asarray(got[0]), p2, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got[1]), o2)
    np.testing.assert_array_equal(np.asarray(got[2]), s2)


def _gs_instance(kind):
    from sslap_tpu import ingest as I
    from tests.utils import random_sparse_instance
    if kind == "random":
        rng = np.random.default_rng(5)
        n = 48
        loc, val, _ = random_sparse_instance(rng, n, n, 0.15, integer=False)
        return I.from_coo(loc, val.astype(np.float32), shape=(n, n)), 5.0
    # rows 0..7: exactly one valid entry (the diagonal); rest: 4 entries
    rng = np.random.default_rng(9)
    n = 24
    locs = [(i, i) for i in range(8)]
    for i in range(8, n):
        locs += [(i, j) for j in {i} | set(rng.integers(0, n, 3).tolist())]
    loc = np.array(sorted(set(locs)))
    val = rng.random(len(loc)).astype(np.float32) * 50 + 1
    prob = I.from_coo(loc, val, shape=(n, n))
    assert (np.asarray(prob.nvalid)[:8] == 1).all()
    return prob, 2.0


@pytest.mark.parametrize("kind", ["random", "single_entry_rows"])
def test_native_gs_matches_numpy_gs(kind):
    """Native C++ Gauss-Seidel vs the pure-numpy engine (gs_host.py):
    identical prices, owner and bid count -- same FIFO order and
    tie-breaks, including the single-valid-entry rule."""
    from sslap_tpu.hybrid import native_available
    if not native_available():
        pytest.skip("native toolchain unavailable")
    from sslap_tpu import hybrid as H
    from sslap_tpu.gs_host import auction_gs_numpy
    from sslap_tpu.native import auction_gs
    prob, eps = _gs_instance(kind)
    n = m = prob.n
    indptr, indices, data = H.ell_to_csr_transformed(prob, -1, 1)
    bigp = np.float32(data.max() - data.min() + 1.0)
    out = []
    for fn in (auction_gs, auction_gs_numpy):
        prices = np.zeros(m, np.float32)
        sigma = np.full(n, -1, np.int32)
        owner = np.full(m, -1, np.int32)
        bids = fn(indptr, indices, data, prices, sigma, owner,
                  np.float32(eps), bigp, 0, 10 ** 7)
        out.append((bids, prices, sigma, owner))
    (b0, p0, s0, o0), (b1, p1, s1, o1) = out
    assert b0 == b1 > 0
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(o0, o1)
    np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("seed,n,m,K", [(0, 257, 300, 5), (1, 64, 64, 3),
                                        (2, 500, 1100, 9)])
def test_wide_w_bit_identical_to_scalar_gather(seed, n, m, K):
    # Window-gather wide round (ops/widebid.py, VERDICT r3 task 6): the
    # col-window-grouped one-hot gather + static sorted join must
    # reproduce vals - prices[cols] BIT-identically, including invalid
    # entries (whose routed value is ignored) and m not a multiple of 128.
    from sslap_tpu.ops.widebid import build_wide_layout, wide_w

    rng = np.random.default_rng(seed)
    cols = rng.integers(0, m, (n, K), dtype=np.int32)
    vals = (rng.random((n, K)) * 100).astype(np.float32)
    valid = rng.random((n, K)) < 0.85
    layout = build_wide_layout(cols, vals, valid, m)
    p = jnp.asarray(rng.random(m).astype(np.float32) * 100)
    ref = vals - np.asarray(p)[np.clip(cols, 0, m - 1)]
    got = np.asarray(jax.jit(lambda p: wide_w(layout, p))(p))
    np.testing.assert_array_equal(got[valid], ref[valid].astype(np.float32))
