"""Window-gather wide-round bid: the column-window-grouped formulation.

The full-width (phase-start) bid round is one random price gather
``prices[cols]`` per stored entry.  This module computes the same
``w = a_ij - p_j`` without a scalar gather: entries grouped by column
window w = col // 128 share a single broadcast 128-lane price line, and
the per-entry pick is an elementwise compare+select.  That produces w in
COLUMN-grouped order, while the per-row top-2 needs ROW-major order; the
join back is a pair sort keyed by the STATIC destination index (the
entry's row-major ELL position).

It was built for an accelerator whose scalar gather was slow.  On the
H100 the 4 MB price table of a 1M-column instance sits in L2, and the
plain gather round beat this one at 1M (PERF.md), so ``wide_rounds``
defaults to off.

The layout is static per instance (cols never change; only prices do),
so ``build_wide_layout`` runs once at ingest/construct time and the
round-time work is pure jnp.  Output is BIT-IDENTICAL to
``vals_t - prices[cols]``: the one-hot sum has exactly one surviving
term, and the subtraction is the same f32 op in a different order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

WINDOW = 128


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class WideLayout:
    """Static column-window-grouped layout for one instance.

    coff    [NB, E] int32   per-entry lane offset (col % 128) within its
                            window; pads are 0
    vals_cg [NB, E] dtype   transformed values in column-grouped order;
                            pads are 0 (their w is discarded by the join)
    dest    [NB*E]  int32   sort key: the entry's row-major ELL flat
                            position (row*K + k); pads get keys >= n*K so
                            they sort to the tail and are sliced away
    n, K, m_pad             logical shape (static); m_pad = NB*128 >= m
    """

    coff: jax.Array
    vals_cg: jax.Array
    dest: jax.Array
    n: int
    K: int
    m_pad: int

    def tree_flatten(self):
        return (self.coff, self.vals_cg, self.dest), \
            (self.n, self.K, self.m_pad)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def build_wide_layout(cols: np.ndarray, vals_t: np.ndarray,
                      valid: np.ndarray, m: int,
                      sign_scale=None, neg=None,
                      E_force: int = 0) -> WideLayout:
    """Host-side one-time layout build.

    Default (``sign_scale`` is None): ``vals_t`` already carries the solve
    transform and sentinel masking.  With ``sign_scale``/``neg``, vals_t
    holds RAW costs and the transform + masking fuse into the build --
    with the native pass (native/build.py:wide_fill, a two-pass counting
    sort) the whole build is O(nnz) with no argsort and no [nnz] temps
    (the numpy pipeline is far slower at 1M x 10).
    Both paths are bit-identical.
    """
    n, K = cols.shape
    if sign_scale is not None:
        try:
            from sslap_tpu.native import wide_fill as _wf_native
        except Exception:   # pragma: no cover
            _wf_native = None
        if _wf_native is not None:
            out = _wf_native(np.asarray(cols), np.asarray(vals_t),
                             np.asarray(valid), m, sign_scale, neg,
                             E_force=E_force)
            if isinstance(out, str):        # "skewed": layout refused
                return None
            if out is not None:
                coff, vals_cg, dest = out
                return WideLayout(
                    coff=jnp.asarray(coff), vals_cg=jnp.asarray(vals_cg),
                    dest=jnp.asarray(dest), n=n, K=K,
                    m_pad=coff.shape[0] * WINDOW)
        # numpy fallback: materialize the masked transform first
        vals_t = np.where(np.asarray(valid),
                          (np.asarray(vals_t)
                           * np.asarray(sign_scale,
                                        np.asarray(vals_t).dtype)),
                          neg).astype(np.asarray(vals_t).dtype)
    nK = n * K
    cols_flat = np.ascontiguousarray(cols, np.int64).reshape(-1)
    # Valid entries clip into [0, m); INVALID slots get a synthetic
    # column spread uniformly across windows (window q % NB, lane 0):
    # ingest gives padding slots col 0, and routing millions of pads
    # into window 0 explodes E (observed: E = 2e6 on a drifted 1M
    # instance -> 64 GB of padding, host OOM).  Invalid w values never
    # influence outputs (below neg/2 on every path).
    cols_flat = np.clip(cols_flat, 0, m - 1)
    NB = -(-m // WINDOW)
    q = np.arange(nK, dtype=np.int64)
    inval = ~np.ascontiguousarray(valid, bool).reshape(-1)
    cols_flat[inval] = np.minimum((q[inval] % NB) * WINDOW, m - 1)
    win = (cols_flat // WINDOW).astype(np.int32)
    # Stable grouping by window; within a window, row-major order is
    # preserved (helps the sort-join's presortedness not at all, but
    # keeps the build deterministic).
    order = np.argsort(win, kind="stable")
    counts = np.bincount(win, minlength=NB)
    E = int(counts.max()) if nK else 1
    if E_force:
        if E > E_force:
            raise ValueError(f"E_force {E_force} < required {E}")
        E = E_force
    if NB * E > 3 * nK + NB * 128:
        # Same skew guard as the native pass: a degenerate window makes
        # the padded layout (and the wide rounds) a net loss.
        return None
    # Lay groups out as [NB, E] with per-window pads at the group tail.
    slot = np.zeros(nK, np.int64)
    starts = np.zeros(NB + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    # position within group = rank of the entry among its window's
    # entries in `order` = index - group start
    grp = win[order].astype(np.int64)
    pos_in_grp = np.arange(nK, dtype=np.int64) - starts[grp]
    slot = grp * E + pos_in_grp                     # [nK] position in [NB*E]

    coff = np.zeros(NB * E, np.int32)
    vals_cg = np.zeros(NB * E, np.asarray(vals_t).dtype)
    dest = np.full(NB * E, np.iinfo(np.int32).max, np.int32)
    coff[slot] = (cols_flat[order] % WINDOW).astype(np.int32)
    vals_cg[slot] = np.ascontiguousarray(vals_t).reshape(-1)[order]
    dest[slot] = order.astype(np.int32)             # row-major ELL position
    # Give pads distinct tail keys so the sort output's first nK slots
    # are exactly the real entries (ties never arise).
    pad = dest == np.iinfo(np.int32).max
    dest[pad] = nK + np.arange(int(pad.sum()), dtype=np.int32)

    return WideLayout(
        coff=jnp.asarray(coff.reshape(NB, E)),
        vals_cg=jnp.asarray(vals_cg.reshape(NB, E)),
        dest=jnp.asarray(dest),
        n=n, K=K, m_pad=NB * WINDOW)


def wide_w(layout: WideLayout, prices: jax.Array) -> jax.Array:
    """w = vals_t - prices[cols] over the whole instance, [n, K], computed
    gather-free: one-hot window select + static sorted join.  Bit-identical
    to the scalar-gather formulation (modulo the caller's valid-mask)."""
    n, K = layout.n, layout.K
    m = prices.shape[0]
    if m < layout.m_pad:
        prices = jnp.pad(prices, (0, layout.m_pad - m))
    p2d = prices.reshape(-1, WINDOW)                          # [NB, 128]
    iota = jnp.arange(WINDOW, dtype=jnp.int32)
    oh = layout.coff[..., None] == iota                       # fused select
    pg = jnp.sum(jnp.where(oh, p2d[:, None, :],
                           jnp.zeros((), prices.dtype)), axis=-1)
    w_cg = (layout.vals_cg - pg).reshape(-1)
    _, w_sorted = lax.sort((layout.dest, w_cg), num_keys=1)
    return w_sorted[: n * K].reshape(n, K)


def build_sharded_wide_layouts(cols: np.ndarray, vals_t: np.ndarray,
                               valid: np.ndarray, m: int, D: int,
                               sign_scale, neg):
    """Per-shard wide layouts with a COMMON group width E, stacked so a
    shard_map'd solve can shard them over the leading axis: returns a
    WideLayout whose coff/vals_cg are [D*NB, E] and dest is [D*NB*E]
    (dest keys are LOCAL row-major positions within each shard), with
    n = n_local and m_pad = NB*128 -- i.e. the aux metadata describes
    ONE shard, matching what each program instance sees after
    shard_map slices the leading axis.  None if any shard's layout is
    refused by the skew guard (callers fall back to scalar rounds)."""
    n_pad = cols.shape[0]
    assert n_pad % D == 0
    n_local = n_pad // D
    per = []
    E = 1
    for s in range(D):
        sl = slice(s * n_local, (s + 1) * n_local)
        lay = build_wide_layout(cols[sl], vals_t[sl], valid[sl], m,
                                sign_scale=sign_scale, neg=neg)
        if lay is None:
            return None
        per.append(lay)
        E = max(E, lay.coff.shape[1])
    if any(p.coff.shape[1] != E for p in per):
        # rebuild the narrow shards at the common width
        for s in range(D):
            if per[s].coff.shape[1] != E:
                sl = slice(s * n_local, (s + 1) * n_local)
                per[s] = build_wide_layout(cols[sl], vals_t[sl], valid[sl],
                                           m, sign_scale=sign_scale,
                                           neg=neg, E_force=E)
    coff = np.concatenate([np.asarray(p.coff) for p in per], axis=0)
    vals_cg = np.concatenate([np.asarray(p.vals_cg) for p in per], axis=0)
    dest = np.concatenate([np.asarray(p.dest) for p in per], axis=0)
    return WideLayout(coff=coff, vals_cg=vals_cg, dest=dest,
                      n=n_local, K=per[0].K, m_pad=per[0].m_pad)
