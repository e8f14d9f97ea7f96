"""Hopcroft-Karp maximum bipartite matching (feasibility layer, T6).

The reference exposes a Cython Hopcroft-Karp both standalone and as the
auction solver's infeasibility pre-check (SURVEY.md SS3a R3, SS4.3).  The
check is a one-shot pre-pass off the hot loop, so the exact implementation
is host-side over CSR structure (a native C++ version is loaded when
available -- sslap_tpu/native).  For large instances the massively
parallel bulk of the matching runs on device first (greedy maximal
matching via propose/accept rounds, feasibility_device.py) and HK only
augments the residual deficit, warm-started from it (``device_seed``).

Algorithm (SURVEY.md SS4.3): repeat { layered BFS from free rows; DFS along
the layer graph augmenting vertex-disjoint paths } until no augmenting path;
O(E * sqrt(V)).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sslap_tpu.ingest import ELLProblem

_INF = np.int64(2 ** 62)

try:  # optional native fast path (sslap_tpu/native, compiled on demand)
    from sslap_tpu.native import hopcroft_karp_native as _hk_native
except Exception:  # pragma: no cover - absence of toolchain
    _hk_native = None


def _ell_to_csr(prob: ELLProblem) -> Tuple[np.ndarray, np.ndarray]:
    valid = np.asarray(prob.valid)
    cols = np.asarray(prob.cols)
    counts = valid.sum(axis=1).astype(np.int64)
    indptr = np.zeros(prob.n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = cols[valid]          # int32: the native i32 HK path's layout
    return indptr, indices


def hopcroft_karp_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    n: int,
    m: int,
    use_native: bool = True,
    init_match: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Maximum matching over a bipartite CSR structure.

    Returns (match_row [n] -> col or -1, match_col [m] -> row or -1, size).
    Deterministic: rows and adjacency are scanned in index order.
    ``init_match`` optionally warm-starts augmentation from an existing
    partial matching (e.g. the device greedy bulk pass) instead of the
    built-in greedy seed.
    """
    indptr = np.ascontiguousarray(indptr, np.int64)
    if use_native and _hk_native is not None:
        if max(n, m) < 2 ** 31:
            # int32 CSR + match arrays: half the memory traffic of the
            # bandwidth-bound BFS/DFS sweeps (measured win at capacity
            # scale; identical scan order -> identical matching).
            from sslap_tpu.native import hopcroft_karp_native_i32
            return hopcroft_karp_native_i32(indptr, indices, n, m,
                                            init_match=init_match)
        indices = np.ascontiguousarray(indices, np.int64)
        if init_match is None:
            return _hk_native(indptr, indices, n, m)
        from sslap_tpu.native import hopcroft_karp_warm_native
        mr = np.ascontiguousarray(init_match[0], np.int64).copy()
        mc = np.ascontiguousarray(init_match[1], np.int64).copy()
        return hopcroft_karp_warm_native(indptr, indices, n, m, mr, mc)
    indices = np.ascontiguousarray(indices, np.int64)

    if init_match is not None:
        match_row = np.asarray(init_match[0], np.int64).copy()
        match_col = np.asarray(init_match[1], np.int64).copy()
    else:
        match_row = np.full(n, -1, np.int64)
        match_col = np.full(m, -1, np.int64)

        # Greedy seed pass (big constant-factor win, standard HK practice).
        for u in range(n):
            for k in range(indptr[u], indptr[u + 1]):
                v = indices[k]
                if match_col[v] == -1:
                    match_col[v] = u
                    match_row[u] = v
                    break

    dist = np.empty(n, np.int64)
    q = np.empty(n, np.int64)
    it = np.empty(n, np.int64)      # per-row adjacency cursor for DFS
    stack = np.empty(n + 1, np.int64)

    size = int((match_row >= 0).sum())

    def bfs() -> bool:
        head = tail = 0
        found = False
        for u in range(n):
            if match_row[u] == -1:
                dist[u] = 0
                q[tail] = u
                tail += 1
            else:
                dist[u] = _INF
        while head < tail:
            u = q[head]
            head += 1
            for k in range(indptr[u], indptr[u + 1]):
                w = match_col[indices[k]]
                if w == -1:
                    found = True
                elif dist[w] == _INF:
                    dist[w] = dist[u] + 1
                    q[tail] = w
                    tail += 1
        return found

    def dfs(root: int) -> bool:
        # Iterative DFS along the layered graph.
        top = 0
        stack[0] = root
        it[root] = indptr[root]
        while top >= 0:
            u = stack[top]
            advanced = False
            while it[u] < indptr[u + 1]:
                v = indices[it[u]]
                it[u] += 1
                w = match_col[v]
                if w == -1:
                    # Augment along the stack.
                    while top >= 0:
                        uu = stack[top]
                        pv = match_row[uu]
                        match_row[uu] = v
                        match_col[v] = uu
                        v = pv
                        top -= 1
                    return True
                if dist[w] == dist[u] + 1:
                    top += 1
                    stack[top] = w
                    it[w] = indptr[w]
                    advanced = True
                    break
            if not advanced:
                dist[u] = _INF   # dead end; prune for this phase
                top -= 1
        return False

    while bfs():
        for u in range(n):
            if match_row[u] == -1:
                if dfs(u):
                    size += 1
    return match_row, match_col, size


def sanitize_matching(prob: ELLProblem,
                      warm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Turn a possibly-stale row->col matching into a valid partial matching
    of ``prob``'s CURRENT pattern (the warm-HK seed for tracking workloads,
    PERF.md round 3: same-pattern reseed 2.6 s vs 64 s cold at 10M rows).

    Drops (a) rows whose matched edge no longer exists in the pattern and
    (b) all but the first row claiming any column.  O(nnz) vectorized.
    Returns (match_row [n], match_col [m]) int64 arrays.
    """
    n, m = prob.n, prob.m
    warm = np.asarray(warm).astype(np.int64, copy=True).ravel()
    if warm.shape[0] != n:
        raise ValueError(f"warm matching has length {warm.shape[0]}, "
                         f"expected n={n}")
    indptr, indices = _ell_to_csr(prob)
    counts = np.diff(indptr)
    rows_of_edges = np.repeat(np.arange(n, dtype=np.int32), counts)
    # edge e survives iff it IS row r(e)'s warm edge
    hit_rows = rows_of_edges[indices == warm[rows_of_edges]]
    ok = np.zeros(n, bool)
    ok[hit_rows] = True
    ok &= (warm >= 0) & (warm < m)
    warm[~ok] = -1
    # one row per column: keep the lowest-index row (deterministic)
    claimed = np.flatnonzero(warm >= 0)
    _, first = np.unique(warm[claimed], return_index=True)
    keep = np.zeros(claimed.shape[0], bool)
    keep[first] = True
    warm[claimed[~keep]] = -1
    match_col = np.full(m, -1, np.int64)
    rows = np.flatnonzero(warm >= 0)
    match_col[warm[rows]] = rows
    return warm, match_col


def hopcroft_karp(prob: ELLProblem, use_native: bool = True,
                  device_seed: Optional[bool] = None,
                  init_match: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """Maximum matching of an ELLProblem's sparsity pattern.

    ``device_seed``: run the device greedy maximal-matching bulk pass
    first (feasibility_device.py) and warm-start HK's augmentation from
    it -- the host then only augments the residual deficit instead of
    building the whole matching serially.  None = auto, which is
    currently HOST: the device seed lost on the earlier accelerator's
    slow host link and is not yet measured on the H100.

    ``init_match``: explicit warm seed (match_row, match_col) -- e.g. from
    ``sanitize_matching`` on a previous solve's matching; overrides
    ``device_seed``."""
    indptr, indices = _ell_to_csr(prob)
    if device_seed is None:
        device_seed = False
    init = init_match
    if init is None and device_seed and prob.n > 0:
        try:
            from sslap_tpu import feasibility_device as _fd
            init = _fd.greedy_matching(prob)
        except Exception:   # device unavailable: plain host HK
            init = None
    return hopcroft_karp_csr(indptr, indices, prob.n, prob.m,
                             use_native=use_native, init_match=init)


def is_feasible(prob: ELLProblem, use_native: bool = True,
                device_seed: Optional[bool] = None) -> bool:
    """True iff a perfect (all-rows) matching exists -- the auction solver's
    cardinality pre-check (SURVEY.md SS1 item 5)."""
    if prob.n == 0:
        return True
    nv = np.asarray(prob.nvalid)
    if (nv == 0).any():
        return False
    _, _, size = hopcroft_karp(prob, use_native=use_native,
                               device_seed=device_seed)
    return size == prob.n
