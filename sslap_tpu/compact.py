"""Tiered active-row-compacted auction solve (single-device fast path).

Why: the plain Jacobi round (auction.py) bids for *all* n rows every round
to keep shapes static, so a round costs O(n*K) HBM traffic + gathers even
when 3 rows are active -- and the tail of every eps phase is serial
eviction chains with tiny active sets (SURVEY.md SS8.2 item 1 solved the
shape problem but not the cost problem).  On 1M x 1M / 10 nnz-per-row a
full round is one random price gather per stored entry, and the full-width
rounds alone would dominate the solve.

Design: keep the active (unassigned, biddable) row ids in a compacted
buffer of *static tier capacity* C, and run rounds whose cost is O(C):

  gather   rows' ELL slices  cols[ids] / vals[ids]      (fast slice gather)
  bid      top-2 over K per active row                  (elementwise)
  resolve  scatter-max per column + min-row tie-break   (C-sized scatters)
  commit   scatter-only price/owner/sigma updates       (C-sized, unique)
  relist   new actives = (bidders that lost) + (evicted previous owners)
           -- both <= C, merged and re-sorted in compact space; the active
           set never grows within a phase, so tiers only step *down*.

Tiers (C = n, then descending powers of two -- see default_tiers for the
x2-spacing rationale) are separate while_loops inside one jit, so the
whole eps-scaled solve is a single device execution with zero host
round-trips.
Narrow tiers (C <= 8192) resolve conflicts with an all-pairs O(C^2)
comparison instead of [m]-sized scatter temporaries.  Per-row data lives
in the line-packed RowPack (one slice gather per active row per round).

Each eps phase opens with one full-width round that doubles as the
eps-CS violator scan (warm-started scaling, auction.py:unassign_violators
semantics): assigned rows whose pair violates eps-CS for the new eps are
unassigned and bid again in that same round, reusing the same w values.

Scope: square effective problems (n == m handled natively; rectangular
n < m falls back to auction.solve_ell's implicit-dummy path in api.py).
Deterministic tie-breaks identical to auction.py: rows pick the lowest
column index among maxima (ELL columns are sorted), columns pick the
lowest row id among max bids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from sslap_tpu import auction as _auction
from sslap_tpu.auction import neg_sentinel

_I32_MAX = 2 ** 31 - 1


class TieredState(NamedTuple):
    prices: jax.Array   # [m]
    owner: jax.Array    # [m] int32, -1 free
    sigma: jax.Array    # [n] int32, -1 free
    eps: jax.Array      # scalar
    rounds: jax.Array   # int32
    phases: jax.Array   # int32
    # per-tier round counters [len(tiers) + 1]: index 0 counts phase-start
    # full-width rounds, 1 + i the ladder rounds at tiers[i].  Drives the
    # perf cost model (PERF.md round 2): per-round cost ~ 18-22 ns x C x K,
    # so this histogram x the probe's per-tier costs explains device time.
    tier_rounds: jax.Array


def default_tiers(n: int, *, fine: bool = False,
                  floor: int = 0) -> Tuple[int, ...]:
    """Static tier capacities, descending.  The top tier is always n (the
    phase-start / bulk rounds); lower tiers shrink the per-round cost as the
    active set collapses into eviction chains.

    Spacing (round 3): a round costs its tier CAPACITY, not the live
    count, so with ratio-r tiers the average capacity/active slack is
    (r-1)/ln r -- 2.16x at round 1's r=4, 1.44x at r=2, ~1.2x with
    {2^k, 3*2^(k-1)} interleaving (ratios alternate 4/3 and 3/2).  The
    interleaved tiers are added ONLY above 32768 by default: upper tiers
    carry the most gathered elements per x2 step (~2M row-fetches each,
    PERF round-3 probe) so the slack cut pays there, while a
    fully-interleaved ladder (25 tiers at 1M) made the XLA program so
    large that the 1M-shape compile did not finish on the earlier
    accelerator's toolchain -- program size is a real budget on this
    axis.

    ``fine`` (round 4) interleaves the 3*2^(k-1) tiers all the way down:
    the sub-32768 tiers hold another ~2M row-fetches EACH at 1M (the
    eviction-chain rounds, tier_rounds histogram in PERF.md round 4), so
    the 1.44x -> ~1.2x slack cut applies there too.  The program-size
    budget is paid for by ``floor``.

    ``floor`` (round 4) drops tiers with capacity <= floor.  The tiered
    drivers never enter a tier whose capacity is at or below the
    truncation threshold (a phase truncates once active <= trunc), so a
    caller with a STATIC trunc can prune those tiers from the program at
    zero behavior change -- callers with traced/zero trunc must pass
    floor=0 and keep the full ladder.

    Round-for-round bit-parity across ladder choices: every round bids
    ALL active rows regardless of tier capacity (capacity only pads), so
    sigma/price trajectories are identical for any ladder -- only the
    per-round padding cost and the tier_rounds histogram change.  This
    is asserted by tests/test_compact.py::test_fine_ladder_parity."""
    tiers = [n]
    c = 1 << max((n - 1).bit_length() - 1, 6)   # largest power of two < n
    while c >= 64:
        half_up = 3 * (c // 2)                  # 1.5 * c, between c and 2c
        if (c >= 32768 or fine) and half_up < n and half_up > c \
                and half_up > floor:
            tiers.append(half_up)
        if c < n and c > floor:
            tiers.append(c)
        c //= 2
    return tuple(tiers)


def _merge_active(stay: jax.Array, evicted: jax.Array, C: int, n: int):
    """Merge two <= C-sized id lists (pad = n) into an ascending compacted
    list of capacity C.  Disjointness: ``stay`` are rows still unassigned
    after losing a bid; ``evicted`` were assigned before this round."""
    cand = jnp.concatenate([stay, evicted])
    cand = lax.sort(cand)
    return cand[:C]


import dataclasses


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class RowPack:
    """Line-packed per-row solver data.

    ``data`` is [L, R*W] int32 where each 128-lane line carries R
    consecutive rows of width W = 2K+1 (cols, value bits, nvalid).  The
    layout was chosen for an accelerator that pads the minor dimension to
    128 lanes, where a plain [n, W] array wastes 128/W of device memory --
    the K-class packing (SURVEY.md SS8.2 item 5) stores R = 128 // W rows
    per line instead.  Row fetches gather the LINE and select the R-slot
    elementwise.  Whether the packing still pays on the H100 (which does
    not pad [n, W]) is not yet measured.
    """

    data: jax.Array
    R: int
    W: int

    def tree_flatten(self):
        return ((self.data,), (self.R, self.W))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(data=children[0], R=aux[0], W=aux[1])


def build_rowpack(cols, vals_m, nvalid, pack_lines: bool = True):
    """Pack (cols, masked vals, nvalid) into line-packed RowPack (or a
    plain [n, 2K+1] int32 array when R would be 1): one slice gather per
    active row per round (PERF.md round-2 table) and ~R x 128/(2K+1) less
    HBM than the separate padded arrays."""
    if jnp.issubdtype(vals_m.dtype, jnp.integer):
        bits = vals_m.astype(jnp.int32)
    else:
        bits = lax.bitcast_convert_type(vals_m, jnp.int32)
    base = jnp.concatenate(
        [cols.astype(jnp.int32), bits, nvalid.astype(jnp.int32)[:, None]],
        axis=1)
    n, W = base.shape
    R = max(128 // W, 1) if pack_lines else 1
    if R == 1:
        return base
    npad = ((n + R - 1) // R) * R
    if npad != n:
        base = jnp.pad(base, ((0, npad - n), (0, 0)))   # nvalid 0: inert
    return RowPack(data=base.reshape(npad // R, R * W), R=R, W=W)


def np_build_rowpack(cols, vals_t, valid, nvalid, sign_scale=None):
    """Host-side rowpack builder: pack BEFORE the device transfer so
    capacity-scale instances never materialize the padded ELL arrays on
    the device (or ship 2x the bytes host-to-device).

    ``sign_scale``: when given, ``vals_t`` holds RAW costs and the min/max
    transform (v * sign * scale) is applied during packing -- with the
    native (C++) packer this makes the whole build ONE fused pass (read
    cols/vals/valid, write the packed image), replacing a numpy pipeline
    measured at 34-61 s for 10M rows (VERDICT round-2 task 3)."""
    import numpy as np
    dtype = np.asarray(vals_t).dtype
    neg = _auction.neg_sentinel_np(dtype)   # host constant: no device touch
    n, K = cols.shape
    W = 2 * K + 1
    R = max(128 // W, 1)
    npad = ((n + R - 1) // R) * R

    ss = 1 if sign_scale is None else sign_scale
    try:
        from sslap_tpu.native import rowpack_fill as _rp_native
    except Exception:   # pragma: no cover
        _rp_native = None
    base = None
    if _rp_native is not None:
        base = _rp_native(np.asarray(cols), np.asarray(vals_t),
                          np.asarray(valid), np.asarray(nvalid),
                          ss, neg, npad)
    if base is None:
        vals_tt = np.asarray(vals_t) if sign_scale is None else \
            (np.asarray(vals_t) * np.asarray(sign_scale, dtype)).astype(dtype)
        vals_m = np.where(valid, vals_tt, neg)
        if np.issubdtype(dtype, np.integer):
            bits = vals_m.astype(np.int32)
        else:
            bits = vals_m.astype(np.float32).view(np.int32)
        base = np.concatenate(
            [cols.astype(np.int32), bits,
             nvalid.astype(np.int32)[:, None]], axis=1)
        if npad != n:
            base = np.pad(base, ((0, npad - n), (0, 0)))
    if R == 1:
        return base
    return RowPack(data=np.ascontiguousarray(base.reshape(npad // R, R * W)),
                   R=R, W=W)


def fetch_rows(rowpack, ids):
    """Gather packed per-row data for ``ids``: [C, W] int32.  Callers mask
    dead ids themselves (clip-mode gathers return arbitrary real rows)."""
    if not isinstance(rowpack, RowPack):
        return rowpack.at[ids].get(mode="clip")
    R, W = rowpack.R, rowpack.W
    lines = rowpack.data.at[ids // R].get(mode="clip")   # [C, R*W]
    lines3 = lines.reshape(ids.shape[0], R, W)
    oh = (ids % R)[:, None] == jnp.arange(R, dtype=jnp.int32)[None, :]
    return jnp.sum(jnp.where(oh[:, :, None], lines3, 0), axis=1)


def _unpack_rows(pk, dtype):
    K = (pk.shape[-1] - 1) // 2
    cols = pk[..., :K]
    bits = pk[..., K:2 * K]
    if jnp.issubdtype(jnp.dtype(dtype), jnp.integer):
        vals = bits.astype(dtype)
    else:
        vals = lax.bitcast_convert_type(bits, dtype)
    return cols, vals, pk[..., 2 * K]


def compact_round(
    rowpack,                       # [n, 2K+1] packed (cols, vals_m, nvalid)
    prices, owner, sigma,
    ids, eps, bigp,
    *,
    phase_start: bool = False,
    pairs_resolve_max: int = 8192,
    w_full=None,
):
    """One auction round over the compacted active set ``ids`` (pad = n).

    ``rowpack`` carries cols + pre-masked transformed values (padding =
    neg sentinel, see mask_vals -- padded slots can never win a top-2) +
    nvalid (for the exact single-valid-entry rule v2 = v1 - bigp and the
    biddable test), packed so the round does ONE slice gather per row.

    With ``phase_start`` the round also performs the warm-started eps-CS
    violator scan: assigned rows in ``ids`` whose pair violates eps-CS at
    the (new) eps are unassigned here and bid immediately.  Otherwise all
    ids are unassigned rows by invariant.

    Resolve strategy: for C <= pairs_resolve_max an all-pairs [C, C]
    comparison picks winners entirely in compact space (no O(m)
    temporaries and none of the ~9 scatter/gather ops per row the scatter
    path pays; the crossover was chosen on the earlier accelerator and is
    not yet measured on the H100);
    larger tiers use the scatter-max/scatter-min path.

    ``w_full``: precomputed full-width w = vals_m - prices[cols] for ALL
    n rows (the window-gather round, ops/widebid.py).  Callers may pass
    it ONLY for identity
    full-width rounds (C == n and ids[i] in {i, n}, the phase-start
    shape): per-position data then equals per-row data, the pack is read
    by reshape instead of gather, and the price gather disappears.
    Bit-identical to the scalar path.

    Returns (prices, owner, sigma, new_ids, n_won, n_evicted).
    """
    n = sigma.shape[0]
    m = prices.shape[0]
    C = ids.shape[0]
    dtype = prices.dtype
    neg = neg_sentinel(dtype)

    live = ids < n
    if w_full is not None:
        assert C == n, "w_full requires the full-width identity round"
        base = (rowpack.data.reshape(-1, rowpack.W)[:n]
                if isinstance(rowpack, RowPack) else rowpack)
        colsC, valsC, nvC = _unpack_rows(base, dtype)
        K = colsC.shape[1]
        nvC = jnp.where(live, nvC, 0)
        w = w_full
    else:
        # clip-mode gathers (not where+gather): sidesteps an XLA compiler
        # CHECK-failure ("cycle detected" in while-loop analysis) once
        # seen with select feeding gather inside nested while bodies.
        pk = fetch_rows(rowpack, ids)           # [C, 2K+1] one slice gather
        colsC, valsC, nvC = _unpack_rows(pk, dtype)
        K = colsC.shape[1]
        nvC = jnp.where(live, nvC, 0)
        w = valsC - prices[colsC]                          # [C, K]
    slot = jnp.argmax(w, axis=1)
    onehot = jnp.arange(K, dtype=jnp.int32)[None, :] == slot[:, None]
    v1 = jnp.max(w, axis=1)
    v2 = jnp.max(jnp.where(onehot, neg, w), axis=1)
    v2 = jnp.where(nvC >= 2, v2, v1 - bigp)
    a_star = jnp.sum(jnp.where(onehot, valsC, jnp.zeros_like(valsC)), axis=1)
    jstar = jnp.sum(jnp.where(onehot, colsC, 0), axis=1).astype(jnp.int32)
    bid = a_star - v2 + eps

    if phase_start:
        sigC = jnp.where(live, sigma.at[ids].get(mode="clip"), -1)
        # Padded slots carry w ~ neg - p, always below neg / 2; real
        # entries stay above it (costs are range-checked at ingest).
        real = w > (neg // 2 if jnp.issubdtype(dtype, jnp.integer)
                    else neg / 2)
        cur_hit = (colsC == sigC[:, None]) & real
        cur = jnp.sum(jnp.where(cur_hit, w, jnp.zeros_like(w)), axis=1)
        viol = (sigC >= 0) & (cur < v1 - eps)
        # Free violators' columns; they re-bid in this very round.
        owner = owner.at[jnp.where(viol, sigC, m)].set(-1, mode="drop")
        sigma = sigma.at[jnp.where(viol, ids, n)].set(-1, mode="drop")
        unassigned = sigC < 0
        bidding = live & (nvC > 0) & (unassigned | viol)
    else:
        bidding = live & (nvC > 0)

    tgt = jnp.where(bidding, jstar, jnp.int32(m))          # m = no bid

    if C <= pairs_resolve_max:
        # All-pairs resolve: i loses iff some j targets the same column
        # with a higher bid, or an equal bid from a lower row id.
        same = tgt[:, None] == tgt[None, :]
        beats = same & ((bid[None, :] > bid[:, None]) |
                        ((bid[None, :] == bid[:, None]) &
                         (ids[None, :] < ids[:, None])))
        won = bidding & jnp.logical_not(jnp.any(beats, axis=1))
    else:
        # Scatter resolve: the shared deterministic tie-break reduction
        # (max bid then lowest row id) -- ONE implementation, auction.py's
        # resolve_bids.  A row won iff it is its column's winner; the
        # fill-mode gather (tgt = m -> _I32_MAX, never a row id) avoids
        # concatenating a sentinel slot onto [m] (an O(m) copy per round).
        _, winner = _auction.resolve_bids(tgt, bid, m, ids)
        won = winner.at[tgt].get(mode="fill",
                                 fill_value=_I32_MAX) == ids

    # Commit by scatter only (won columns are unique: one winner each).
    tgt_won = jnp.where(won, tgt, jnp.int32(m))
    prev_owner = jnp.where(won, owner.at[tgt].get(mode="clip"), -1)
    prices = prices.at[tgt_won].set(jnp.where(won, bid, prices[0]),
                                    mode="drop")
    owner = owner.at[tgt_won].set(ids, mode="drop")
    evicted = jnp.where(prev_owner >= 0, prev_owner, jnp.int32(n))
    # One fused sigma scatter: winners install their column, evictees
    # clear (disjoint row sets: an assigned row never bids this round).
    sig_idx = jnp.concatenate([jnp.where(won, ids, n), evicted])
    sig_val = jnp.concatenate([tgt, jnp.full((evicted.shape[0],), -1,
                                             jnp.int32)])
    sigma = sigma.at[sig_idx].set(sig_val, mode="drop")

    stay = jnp.where(bidding & jnp.logical_not(won), ids, jnp.int32(n))
    new_ids = _merge_active(stay, evicted, C, n)
    n_won = jnp.sum(won).astype(jnp.int32)
    n_evicted = jnp.sum(prev_owner >= 0).astype(jnp.int32)
    return prices, owner, sigma, new_ids, n_won, n_evicted


def mask_vals(vals_t, valid):
    """Pre-mask transformed values: padding = neg sentinel, so the per-round
    validity gather disappears (done once per solve)."""
    return jnp.where(valid, vals_t, neg_sentinel(vals_t.dtype))


def tier_ladder(
    rowpack,
    prices, owner, sigma, ids, active, rounds, eps,
    *,
    bigp,
    tiers: Tuple[int, ...],
    threshold=0,
    max_iter,
    tier_rounds=None,
):
    """Descend the tier ladder at fixed eps: compact rounds at capacity C
    while ``active`` exceeds max(next tier, threshold); stop once active
    <= threshold (0 = run to completion).  ``threshold`` may be a traced
    value (no recompile per setting).  ``ids`` must be an ascending
    compacted id buffer (capacity tiers[0]).

    Returns (prices, owner, sigma, ids, active, rounds).  Note: when
    threshold > 0 the returned ids buffer may have been narrowed below the
    live active count (harmless -- callers rebuild the list per phase);
    only active/state outputs are authoritative."""
    n = sigma.shape[0]
    threshold = jnp.asarray(threshold, jnp.int32)
    if tier_rounds is None:
        tier_rounds = jnp.zeros((len(tiers) + 1,), jnp.int32)
    carry = (prices, owner, sigma, ids, active, rounds, eps)
    for ti, C in enumerate(tiers):
        floor_static = tiers[ti + 1] if ti + 1 < len(tiers) else 0

        def cond(c, floor_static=floor_static):
            _, _, _, _, act, rnd, _ = c
            return (act > jnp.maximum(jnp.int32(floor_static), threshold)) \
                & (rnd < max_iter)

        def body(c):
            prices, owner, sigma, ids, act, rnd, eps = c
            prices, owner, sigma, ids, n_won, n_evi = compact_round(
                rowpack, prices, owner, sigma, ids, eps, bigp)
            act = act - n_won + n_evi
            return (prices, owner, sigma, ids, act, rnd + 1, eps)

        if C != tiers[0]:
            # Re-compact the id buffer down to this tier's capacity.
            # Valid ids are the ascending prefix (pad = n sorts last);
            # the previous tier's cond guarantees active <= C whenever this
            # tier's loop actually runs.
            prices, owner, sigma, ids, act, rnd, eps = carry
            ids = ids[:C]
            carry = (prices, owner, sigma, ids, act, rnd, eps)
        rounds_before = carry[5]
        carry = lax.while_loop(cond, body, carry)
        tier_rounds = tier_rounds.at[ti + 1].add(carry[5] - rounds_before)
    prices, owner, sigma, ids, active, rounds, eps = carry
    return prices, owner, sigma, ids, active, rounds, tier_rounds


def solve_ell_tiered(
    cols: jax.Array,
    vals_t: jax.Array,
    valid: jax.Array,
    nvalid: jax.Array,
    p0: jax.Array,
    eps0,
    eps_min,
    theta,
    max_iter,
    tiers: Optional[Tuple[int, ...]] = None,
    bigp=None,
    trunc=0,
    init_state: Optional[TieredState] = None,
    max_phases: Optional[int] = None,
    theta_tail=None,
    tail_phases: int = 2,
    wide_layout=None,
):
    """eps-scaled tiered-compaction solve for square effective problems
    (no implicit dummies).  Same result contract as auction.solve_ell.

    ``trunc`` > 0 truncates every phase once <= trunc rows are active: the
    narrow serial eviction chains (measured: ~82% of rounds carry < 16 bids
    each) are left unfinished and the solver returns with unassigned > 0.
    Used by the hybrid driver, whose single native host GS pass at eps_min
    completes the assignment -- correctness only needs the *final* phase
    completed at eps_min; truncated earlier phases merely precondition
    prices.

    Resume / checkpoint: ``max_phases`` bounds the eps phases run in THIS
    call; pass the previous call's second return value (a TieredState)
    back as ``init_state`` to continue -- TieredState is a plain NamedTuple
    pytree, so host-side numpy snapshots round-trip through it.  Phase
    boundaries are exact resume points -- (prices, owner, sigma, eps) is
    the whole algorithm state (SURVEY.md SS6 'Checkpoint / resume'), so a
    periodic host snapshot between calls makes long solves crash-proof."""
    n, K = cols.shape
    dtype = vals_t.dtype
    neg = neg_sentinel(dtype)
    pos = -neg
    if bigp is None:
        vmax = jnp.max(jnp.where(valid, vals_t, neg))
        vmin = jnp.min(jnp.where(valid, vals_t, pos))
        one = jnp.asarray(1, dtype)
        bigp = jnp.maximum(vmax - vmin, jnp.zeros_like(one)) + one
    rowpack = build_rowpack(cols, mask_vals(vals_t, valid), nvalid)
    return solve_rowpack_tiered(
        rowpack, nvalid, p0, eps0, eps_min, theta, max_iter,
        tiers=tiers, bigp=bigp, trunc=trunc, init_state=init_state,
        max_phases=max_phases, theta_tail=theta_tail,
        tail_phases=tail_phases, wide_layout=wide_layout)


def solve_rowpack_tiered(
    rowpack,
    nvalid: jax.Array,
    p0: jax.Array,
    eps0,
    eps_min,
    theta,
    max_iter,
    *,
    bigp,
    tiers: Optional[Tuple[int, ...]] = None,
    trunc=0,
    init_state: Optional[TieredState] = None,
    max_phases: Optional[int] = None,
    theta_tail=None,
    tail_phases: int = 2,
    wide_layout=None,
):
    """Tiered solve over pre-packed per-row data (see solve_ell_tiered for
    the contract).  Taking a RowPack directly matters at capacity scale:
    a host-packed 10M-row instance ships ~1 GB to the device instead of
    the >16 GB the separate lane-padded ELL arrays would occupy
    (SURVEY.md SS8.2 item 5 / VERDICT round-1 item 2)."""
    n = nvalid.shape[0]
    m = p0.shape[0]
    dtype = p0.dtype
    if tiers is None:
        tiers = default_tiers(n)
    assert tiers[0] == n, "top tier must cover all rows"
    bigp = jnp.asarray(bigp, dtype)

    eps0 = jnp.maximum(jnp.asarray(eps0, dtype), jnp.asarray(eps_min, dtype))
    eps_min = jnp.asarray(eps_min, dtype)
    theta = jnp.asarray(theta, dtype)
    max_iter = jnp.asarray(max_iter, jnp.int32)
    all_rows = jnp.arange(n, dtype=jnp.int32)

    def count_active(ids):
        return jnp.sum(ids < n).astype(jnp.int32)

    def run_phase(st: TieredState, first: bool) -> TieredState:
        prices, owner, sigma = st.prices, st.owner, st.sigma
        # Phase-start full-width round: violator scan + first bids fused.
        ids_full = jnp.where((sigma < 0) & (nvalid > 0) | (sigma >= 0),
                             all_rows, jnp.int32(n))
        if first:
            # Everything unassigned; restrict to biddable rows.
            ids_full = jnp.where(nvalid > 0, all_rows, jnp.int32(n))
        w_full = None
        if wide_layout is not None:
            # Window-gather full-width w (ops/widebid.py), bit-identical
            # to the scalar gather.
            from sslap_tpu.ops.widebid import wide_w
            w_full = wide_w(wide_layout, prices)
        prices, owner, sigma, ids, n_won, n_evi = compact_round(
            rowpack, prices, owner, sigma,
            ids_full, st.eps, bigp, phase_start=not first, w_full=w_full)
        rounds = st.rounds + 1
        tier_rounds = st.tier_rounds.at[0].add(1)
        active = count_active(ids)

        if wide_layout is not None:
            # Keep running FULL-WIDTH window rounds while the active set
            # is wider than 0.4n (the crossover against the compacted
            # round's scalar gathers, set on the earlier accelerator).
            # Every round bids the same active set either way, so the
            # solve stays bit-identical to the ladder path.
            from sslap_tpu.ops.widebid import wide_w as _wide_w
            wide_floor = jnp.int32((2 * n) // 5)

            def wcond(c):
                _, _, _, _, act, rnd = c
                return (act > wide_floor) & (rnd < max_iter)

            def wbody(c):
                prices, owner, sigma, ids, act, rnd = c
                idsf = jnp.where((sigma < 0) & (nvalid > 0), all_rows,
                                 jnp.int32(n))
                wf = _wide_w(wide_layout, prices)
                prices, owner, sigma, ids, n_won, n_evi = compact_round(
                    rowpack, prices, owner, sigma, idsf, st.eps, bigp,
                    w_full=wf)
                return (prices, owner, sigma, ids, act - n_won + n_evi,
                        rnd + 1)

            rb = rounds
            (prices, owner, sigma, ids, active, rounds) = lax.while_loop(
                wcond, wbody, (prices, owner, sigma, ids, active, rounds))
            tier_rounds = tier_rounds.at[0].add(rounds - rb)

        prices, owner, sigma, ids, active, rounds, tier_rounds = tier_ladder(
            rowpack,
            prices, owner, sigma, ids, active, rounds, st.eps,
            bigp=bigp, tiers=tiers, threshold=trunc, max_iter=max_iter,
            tier_rounds=tier_rounds)
        return st._replace(prices=prices, owner=owner, sigma=sigma,
                           rounds=rounds, phases=st.phases + 1,
                           tier_rounds=tier_rounds)

    # First phase (everything unassigned) unless resuming from a phase
    # boundary, then eps-descent phases.
    if init_state is None:
        init = TieredState(
            prices=p0.astype(dtype),
            owner=jnp.full((m,), -1, jnp.int32),
            sigma=jnp.full((n,), -1, jnp.int32),
            eps=eps0,
            rounds=jnp.int32(0),
            phases=jnp.int32(0),
            tier_rounds=jnp.zeros((len(tiers) + 1,), jnp.int32),
        )
        st = run_phase(init, first=True)
    else:
        st = init_state._replace(
            prices=jnp.asarray(init_state.prices, dtype),
            eps=jnp.asarray(init_state.eps, dtype))
    phase_budget = (jnp.int32(2 ** 30) if max_phases is None
                    else st.phases + jnp.int32(max_phases))

    def outer_cond(carry):
        st, done = carry
        return jnp.logical_not(done) & (st.phases < phase_budget)

    def outer_body(carry):
        st, _ = carry
        new_eps = _auction._next_eps(st.eps, theta, eps_min,
                                     theta_tail=theta_tail,
                                     tail_phases=tail_phases)
        st = run_phase(st._replace(eps=new_eps), first=False)
        done = (st.eps <= eps_min) | (st.rounds >= max_iter)
        return st, done

    done0 = (st.eps <= eps_min) | (st.rounds >= max_iter)
    st, _ = lax.while_loop(outer_cond, outer_body, (st, done0))

    unassigned = jnp.sum((st.sigma < 0) & (nvalid > 0)).astype(jnp.int32)
    result = _auction.SolveResult(
        sigma=st.sigma, prices=st.prices, rounds=st.rounds,
        phases=st.phases, final_eps=st.eps, unassigned=unassigned,
    )
    return result, st
