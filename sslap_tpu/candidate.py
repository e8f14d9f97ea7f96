"""Candidate-list tiered auction solve (single-device fast path, round 2).

Motivation: every round of the compact solver pays K+1 scalar gathers per
active row (the price gather dominates), and full-width phase-start rounds
gather every stored entry.  This engine is the classic Bertsekas
candidate-list ("similar objects") auction mapped to the device:

  Each row carries a SHORTLIST of its kappa best entries (columns + values)
  plus a threshold tau = the (kappa+1)-th best w at build time.  Prices are
  monotone non-decreasing over the whole solve, so every non-shortlist
  entry's w = a - p only falls: tau is a PERMANENT upper bound for all
  outside entries.  A fast round then needs only (kappa + 1) gathers/row:

    v1 = max over shortlist of (a - p);  certified iff v1 >= tau
    certified  -> bid on the shortlist argmax with v2' = max(v2_sc, tau)
                  (v2' >= true v2  =>  UNDERBID: eps-CS preserved;
                   v2' <= v1       =>  bid >= p[j*] + eps: a real raise)
    uncertified -> the global argmax may be outside: queue for RESCAN

  Rescan rounds re-gather a row's full ELL slice (K gathers), rebuild its
  shortlist + tau via top-(kappa+1), and bid exactly.  Rescans batch at a
  fraction of the tier capacity and are skipped (lax.cond) when the
  backlog is empty.

Phase starts are kappa-cheap too: the eps-CS violator test uses the upper
bound v1' = max(v1_sc, tau) -- it can only over-unassign (harmless: an
unassigned row re-bids; correctness and termination are the standard
auction arguments), never miss a true violator.  Only the FIRST phase pays
a true full scan (it builds all shortlists).

Same result contract and tie-break rules as compact.solve_ell_tiered
(lowest-column argmax per row, lowest-row-id per column), square problems
only; compact.py remains the exact-scan reference engine and resume
carrier.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from sslap_tpu import auction as _auction
from sslap_tpu.auction import neg_sentinel, neg_sentinel_value

_I32_MAX = 2 ** 31 - 1
DEFAULT_KAPPA = 4


class CandState(NamedTuple):
    prices: jax.Array       # [m]
    owner: jax.Array        # [m] int32, -1 free
    sigma: jax.Array        # [n] int32, -1 free
    sc_cols: jax.Array      # [n, kappa] int32 shortlist columns
    sc_vals: jax.Array      # [n, kappa] dtype shortlist values (neg = empty)
    sc_tau: jax.Array       # [n] dtype upper bound on non-shortlist w
    eps: jax.Array
    rounds: jax.Array
    phases: jax.Array
    rescans: jax.Array      # int32 total rescanned rows (perf counter)
    tier_rounds: jax.Array  # [len(tiers)+1]: [phase starts, ladder tiers...]


def _topk_shortlist(wC, colsC, valsC, kappa: int, bigp):
    """Top-(kappa+1) of wC [C, K]: returns (sc_cols, sc_vals, tau, v1, v2,
    jstar, a_star).  Ties resolve to the lowest slot = lowest column (ELL
    columns are sorted ascending)."""
    C, K = wC.shape
    dtype = wC.dtype
    neg = neg_sentinel(dtype)
    kk = min(kappa + 1, K)
    topw, topi = lax.top_k(wC, kk)                 # stable: lowest idx first
    slot_oh = (jnp.arange(K, dtype=jnp.int32)[None, None, :]
               == topi[:, :, None])                # [C, kk, K]
    top_cols = jnp.sum(jnp.where(slot_oh, colsC[:, None, :], 0),
                       axis=2).astype(jnp.int32)
    top_vals = jnp.sum(jnp.where(slot_oh, valsC[:, None, :],
                                 jnp.zeros_like(valsC[:, None, :])), axis=2)
    # invalidate slots whose w is the padding sentinel (beyond nvalid)
    real = topw > (neg // 2 if jnp.issubdtype(dtype, jnp.integer)
                   else neg / 2)
    sc_n = min(kappa, K)
    sc_cols = jnp.where(real[:, :sc_n], top_cols[:, :sc_n], 0)
    sc_vals = jnp.where(real[:, :sc_n], top_vals[:, :sc_n], neg)
    if kk > kappa:
        tau = jnp.where(real[:, kappa], topw[:, kappa], neg)
    else:
        tau = jnp.full((C,), neg, dtype)
    if sc_n < kappa:                               # K < kappa: pad shortlist
        padc = jnp.zeros((C, kappa - sc_n), jnp.int32)
        padv = jnp.full((C, kappa - sc_n), neg, dtype)
        sc_cols = jnp.concatenate([sc_cols, padc], axis=1)
        sc_vals = jnp.concatenate([sc_vals, padv], axis=1)
    v1 = topw[:, 0]
    has2 = (real[:, 1] if kk >= 2
            else jnp.zeros((C,), bool))
    v2 = jnp.where(has2, topw[:, 1] if kk >= 2 else v1, v1 - bigp)
    jstar = top_cols[:, 0]
    a_star = top_vals[:, 0]
    return sc_cols, sc_vals, tau, v1, v2, jstar, a_star


def _fast_bids(scpack_rows, prices, sigma_rows, live, eps, bigp, kappa: int,
               dtype, m, phase_start: bool):
    """Shortlist bids for gathered rows.  Returns (tgt, bid, uncertified,
    viol_unassign) -- tgt == m for non-bidders."""
    neg = neg_sentinel(dtype)
    sc_cols = scpack_rows[:, :kappa]
    sc_vals = _bits_to(scpack_rows[:, kappa:2 * kappa], dtype)
    tau = _bits_to(scpack_rows[:, 2 * kappa], dtype)
    nv = scpack_rows[:, 2 * kappa + 1]

    p_sc = prices[sc_cols]                          # [C, kappa] gathers
    real = sc_vals > (neg // 2 if jnp.issubdtype(dtype, jnp.integer)
                      else neg / 2)
    w = jnp.where(real, sc_vals - p_sc, neg)
    v1 = jnp.max(w, axis=1)
    # Tie-break among w maxima by the LOWEST column index (shortlist slots
    # are ordered by build-time w, not column, so a plain argmax would
    # resolve ties in slot order and diverge from the compact engine's
    # documented contract).
    is_max = w == v1[:, None]
    colkey = jnp.where(is_max, sc_cols, jnp.int32(_I32_MAX))
    slot = jnp.argmin(colkey, axis=1)
    onehot = jnp.arange(w.shape[1], dtype=jnp.int32)[None, :] == slot[:, None]
    v2 = jnp.max(jnp.where(onehot, neg, w), axis=1)
    has2 = jnp.sum(real, axis=1) >= 2
    v2 = jnp.where(has2, v2, v1 - bigp)
    v2p = jnp.maximum(v2, tau)                      # underbid-safe bound
    v2p = jnp.where(nv >= 2, v2p, v1 - bigp)
    a_star = jnp.sum(jnp.where(onehot, sc_vals, jnp.zeros_like(sc_vals)),
                     axis=1)
    jstar = jnp.sum(jnp.where(onehot, sc_cols, 0), axis=1).astype(jnp.int32)
    bid = a_star - v2p + eps

    certified = v1 >= tau                           # tau == neg certifies
    if phase_start:
        # eps-CS violator scan with the v1 upper bound (over-unassigns at
        # worst; never misses a violator).  sigma in shortlist by invariant
        # for rows assigned by THIS engine; `found` guards the rest.
        sig = sigma_rows
        hit = (sc_cols == sig[:, None]) & real
        found = jnp.any(hit, axis=1)
        cur = jnp.sum(jnp.where(hit, w, jnp.zeros_like(w)), axis=1)
        v1p = jnp.maximum(v1, tau)
        assigned = sig >= 0
        viol = assigned & (jnp.logical_not(found) | (cur < v1p - eps))
        wants = live & (nv > 0) & (jnp.logical_not(assigned) | viol)
    else:
        viol = jnp.zeros(sigma_rows.shape, bool)
        wants = live & (nv > 0)

    bidding = wants & certified
    uncert = wants & jnp.logical_not(certified)
    tgt = jnp.where(bidding, jstar, jnp.int32(m))
    return tgt, bid, uncert, viol


def _to_bits(x, dtype):
    if jnp.issubdtype(dtype, jnp.integer):
        return x.astype(jnp.int32)
    return lax.bitcast_convert_type(x, jnp.int32)


def _bits_to(x, dtype):
    if jnp.issubdtype(jnp.dtype(dtype), jnp.integer):
        return x.astype(dtype)
    return lax.bitcast_convert_type(x, dtype)


def build_scpack(sc_cols, sc_vals, sc_tau, nvalid, kappa: int):
    """Pack shortlist state into ONE [n, 2*kappa + 2] i32 array so a fast
    round does a single 6.5 ns slice gather per row (PERF.md: slice-gather
    cost is per ROW, independent of width)."""
    dtype = sc_vals.dtype
    return jnp.concatenate([
        sc_cols.astype(jnp.int32),
        _to_bits(sc_vals, dtype),
        _to_bits(sc_tau, dtype)[:, None],
        nvalid.astype(jnp.int32)[:, None],
    ], axis=1)


def candidate_round(
    rowpack, scpack,
    prices, owner, sigma,
    ids, backlog, eps, bigp,
    *,
    kappa: int,
    resc_cap: int,
    phase_start: bool = False,
    pairs_resolve_max: int = 8192,
):
    """One round: fast shortlist bids over ``ids`` [C] + a batched rescan of
    ``backlog[:resc_cap]`` (skipped when empty).  Returns (scpack, prices,
    owner, sigma, new_ids, new_backlog, n_won, n_evicted, n_rescanned)."""
    from sslap_tpu import compact as _compact
    n = sigma.shape[0]
    m = prices.shape[0]
    C = ids.shape[0]
    dtype = prices.dtype
    neg = neg_sentinel(dtype)
    resc_cap = min(resc_cap, backlog.shape[0])

    live = ids < n
    pk = scpack.at[ids].get(mode="clip")            # [C, 2k+2] one gather
    sigC = jnp.where(live, sigma.at[ids].get(mode="clip"), -1)
    tgt_f, bid_f, uncert, violF = _fast_bids(
        pk, prices, sigC, live, eps, bigp, kappa, dtype, m, phase_start)

    # ---- rescan part (lax.cond: skip the K-wide gathers when idle) ------
    rids = backlog[:resc_cap]
    rlive = rids < n
    n_resc = jnp.sum(rlive).astype(jnp.int32)

    def do_rescan(operands):
        scpack, prices, owner, sigma = operands
        pkR = _compact.fetch_rows(rowpack, rids)    # [Cr, 2K+1] one gather
        colsR, valsR, nvR = _compact._unpack_rows(pkR, dtype)
        wR = valsR - prices[colsR]
        sc_c, sc_v, tau, v1, v2, jstar, a_star = _topk_shortlist(
            wR, colsR, valsR, kappa, bigp)
        nvR = jnp.where(rlive, nvR, 0)
        v2 = jnp.where(nvR >= 2, v2, v1 - bigp)
        bid = a_star - v2 + eps
        if phase_start:
            # Exact eps-CS violator scan fused into the full rescan (the
            # full row is in hand, so cur and v1 are exact -- no
            # over-unassignment): assigned violators free their column
            # and re-bid in this same round.
            sigR = jnp.where(rlive, sigma.at[rids].get(mode="clip"), -1)
            real = wR > (neg // 2 if jnp.issubdtype(dtype, jnp.integer)
                         else neg / 2)
            hit = (colsR == sigR[:, None]) & real
            cur = jnp.sum(jnp.where(hit, wR, jnp.zeros_like(wR)), axis=1)
            viol = (sigR >= 0) & (cur < v1 - eps)
            owner = owner.at[jnp.where(viol, sigR, m)].set(-1, mode="drop")
            sigma = sigma.at[jnp.where(viol, rids, n)].set(-1, mode="drop")
            unassignedR = jnp.where(viol, True, sigR < 0)
            bidding = rlive & (nvR > 0) & unassignedR
        else:
            bidding = rlive & (nvR > 0)
        tgt = jnp.where(bidding, jstar, jnp.int32(m))
        upd = build_scpack(sc_c, sc_v, tau, nvR, kappa)
        scpack = scpack.at[jnp.where(rlive, rids, n)].set(upd, mode="drop")
        return scpack, owner, sigma, tgt, bid

    def no_rescan(operands):
        scpack, prices, owner, sigma = operands
        return (scpack, owner, sigma,
                jnp.full((resc_cap,), m, jnp.int32),
                jnp.zeros((resc_cap,), dtype))

    scpack, owner, sigma, tgt_r, bid_r = lax.cond(
        n_resc > 0, do_rescan, no_rescan, (scpack, prices, owner, sigma))

    # ---- joint resolve over fast + rescan bids --------------------------
    all_ids = jnp.concatenate([ids, jnp.where(rlive, rids, jnp.int32(n))])
    all_tgt = jnp.concatenate([tgt_f, tgt_r])
    all_bid = jnp.concatenate([bid_f, bid_r])
    CT = C + resc_cap
    bidding_all = all_tgt < m

    if phase_start:
        # Violators freed here re-bid in this same round; mirror
        # compact_round's bookkeeping: free the column/sigma of fast-part
        # violators before commit.
        owner = owner.at[jnp.where(violF, sigC, m)].set(-1, mode="drop")
        sigma = sigma.at[jnp.where(violF, ids, n)].set(-1, mode="drop")

    if CT <= pairs_resolve_max:
        same = all_tgt[:, None] == all_tgt[None, :]
        beats = same & ((all_bid[None, :] > all_bid[:, None]) |
                        ((all_bid[None, :] == all_bid[:, None]) &
                         (all_ids[None, :] < all_ids[:, None])))
        won = bidding_all & jnp.logical_not(jnp.any(beats, axis=1))
    else:
        best = jnp.full((m,), neg, dtype).at[all_tgt].max(all_bid,
                                                          mode="drop")
        is_best = all_bid == best.at[all_tgt].get(
            mode="fill", fill_value=neg_sentinel_value(dtype))
        cand = jnp.where(is_best, all_ids, jnp.int32(_I32_MAX))
        winner = (jnp.full((m,), _I32_MAX, jnp.int32)
                  .at[all_tgt].min(cand, mode="drop"))
        won = is_best & (winner.at[all_tgt].get(
            mode="fill", fill_value=_I32_MAX) == all_ids)

    tgt_won = jnp.where(won, all_tgt, jnp.int32(m))
    prev_owner = jnp.where(won, owner.at[all_tgt].get(mode="clip"), -1)
    prices = prices.at[tgt_won].set(jnp.where(won, all_bid, prices[0]),
                                    mode="drop")
    owner = owner.at[tgt_won].set(all_ids, mode="drop")
    sigma = sigma.at[jnp.where(won, all_ids, n)].set(tgt_won, mode="drop")
    evicted = jnp.where(prev_owner >= 0, prev_owner, jnp.int32(n))
    sigma = sigma.at[evicted].set(-1, mode="drop")

    # ---- relist ---------------------------------------------------------
    won_f, won_r = won[:C], won[C:]
    stay_fast = jnp.where((tgt_f < m) & jnp.logical_not(won_f), ids,
                          jnp.int32(n))
    stay_resc = jnp.where(rlive & (tgt_r < m) & jnp.logical_not(won_r),
                          rids, jnp.int32(n))
    new_ids = lax.sort(jnp.concatenate(
        [stay_fast, stay_resc, evicted]))[:C]
    uncert_ids = jnp.where(uncert, ids, jnp.int32(n))
    new_backlog = lax.sort(jnp.concatenate(
        [backlog[resc_cap:], uncert_ids,
         jnp.full((resc_cap,), n, jnp.int32)]))[:backlog.shape[0]]
    n_won = jnp.sum(won).astype(jnp.int32)
    n_evi = jnp.sum(prev_owner >= 0).astype(jnp.int32)
    return (scpack, prices, owner, sigma, new_ids, new_backlog,
            n_won, n_evi, n_resc)


def solve_ell_candidates(
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
    kappa: int = DEFAULT_KAPPA,
):
    """eps-scaled candidate-list solve for square effective problems.
    Same result contract as compact.solve_ell_tiered (plus the engine's
    rescan counter in the returned state)."""
    from sslap_tpu import compact as _compact
    n, K = cols.shape
    m = p0.shape[0]
    dtype = vals_t.dtype
    neg = neg_sentinel(dtype)
    pos = -neg
    if tiers is None:
        tiers = _compact.default_tiers(n)
    assert tiers[0] == n

    if bigp is None:
        vmax = jnp.max(jnp.where(valid, vals_t, neg))
        vmin = jnp.min(jnp.where(valid, vals_t, pos))
        one = jnp.asarray(1, dtype)
        bigp = jnp.maximum(vmax - vmin, jnp.zeros_like(one)) + one
    else:
        bigp = jnp.asarray(bigp, dtype)

    eps0 = jnp.maximum(jnp.asarray(eps0, dtype), jnp.asarray(eps_min, dtype))
    eps_min = jnp.asarray(eps_min, dtype)
    theta = jnp.asarray(theta, dtype)
    max_iter = jnp.asarray(max_iter, jnp.int32)
    trunc = jnp.asarray(trunc, jnp.int32)
    all_rows = jnp.arange(n, dtype=jnp.int32)
    rowpack = _compact.build_rowpack(cols, _compact.mask_vals(vals_t, valid),
                                     nvalid)

    def count_active(ids, backlog):
        return (jnp.sum(ids < n) + jnp.sum(backlog < n)).astype(jnp.int32)

    def ladder(scpack, prices, owner, sigma, ids, backlog, active, rounds,
               rescans, eps, switch: int = 4096):
        """Tier descent: candidate rounds at wide tiers (C > ``switch``,
        where the (K-kappa) gather savings dominate), plain compact rounds
        below (cheap anyway; avoids the rescan ping-pong and underbid
        round inflation measured on serial eviction chains).  The rescan
        backlog folds into the id buffer at the switch."""
        carry = (scpack, prices, owner, sigma, ids, backlog, active,
                 rounds, rescans)
        tier_rounds = []
        merged = False
        for ti, Ct in enumerate(tiers):
            floor_static = tiers[ti + 1] if ti + 1 < len(tiers) else 0
            resc_cap = max(min(Ct // 2, 8192), 32)

            def cond(c, floor_static=floor_static):
                act, rnd = c[6], c[7]
                return (act > jnp.maximum(jnp.int32(floor_static), trunc)) \
                    & (rnd < max_iter)

            def cand_body(c, resc_cap=resc_cap):
                (scpack, prices, owner, sigma, ids, backlog, act, rnd,
                 rsc) = c
                (scpack, prices, owner, sigma, ids, backlog, n_won, n_evi,
                 n_resc) = candidate_round(
                    rowpack, scpack, prices, owner, sigma,
                    ids, backlog, eps, bigp, kappa=kappa, resc_cap=resc_cap)
                return (scpack, prices, owner, sigma, ids, backlog,
                        act - n_won + n_evi, rnd + 1, rsc + n_resc)

            def compact_body(c):
                (scpack, prices, owner, sigma, ids, backlog, act, rnd,
                 rsc) = c
                prices, owner, sigma, ids, n_won, n_evi = \
                    _compact.compact_round(
                        rowpack, prices, owner, sigma, ids, eps, bigp)
                return (scpack, prices, owner, sigma, ids, backlog,
                        act - n_won + n_evi, rnd + 1, rsc)

            if Ct != tiers[0]:
                (scpack, prices, owner, sigma, ids, backlog, act, rnd,
                 rsc) = carry
                ids, backlog = ids[:Ct], backlog[:Ct]
                if Ct <= switch and not merged:
                    # entering the compact regime: absorb the backlog
                    ids = lax.sort(jnp.concatenate([ids, backlog]))[:Ct]
                    backlog = jnp.full((Ct,), n, jnp.int32)
                    merged = True
                carry = (scpack, prices, owner, sigma, ids, backlog, act,
                         rnd, rsc)
            elif Ct <= switch:
                merged = True   # tiny problems: compact from the top
                (scpack, prices, owner, sigma, ids, backlog, act, rnd,
                 rsc) = carry
                ids = lax.sort(jnp.concatenate([ids, backlog]))[
                    :ids.shape[0]]
                backlog = jnp.full(backlog.shape, n, jnp.int32)
                carry = (scpack, prices, owner, sigma, ids, backlog, act,
                         rnd, rsc)
            body = compact_body if Ct <= switch else cand_body
            rounds_before = carry[7]
            carry = lax.while_loop(cond, body, carry)
            tier_rounds.append(carry[7] - rounds_before)
        return carry + (jnp.stack(tier_rounds),)

    def run_phase(st: CandState, first: bool) -> CandState:
        scpack = build_scpack(st.sc_cols, st.sc_vals, st.sc_tau, nvalid,
                              kappa)
        prices, owner, sigma = st.prices, st.owner, st.sigma
        if first:
            # Initial full scan: build every shortlist and take first bids
            # via one full-width rescan round (the only mandatory full
            # scan of the solve).
            ids0 = jnp.full((n,), n, jnp.int32)
            backlog0 = jnp.where(nvalid > 0, all_rows, jnp.int32(n))
            (scpack, prices, owner, sigma, ids, backlog, n_won, n_evi,
             n_resc) = candidate_round(
                rowpack, scpack, prices, owner, sigma,
                ids0, backlog0, st.eps, bigp, kappa=kappa, resc_cap=n)
            rescans = st.rescans + n_resc
        else:
            # Phase start = full-width rescan: rebuild EVERY biddable
            # row's shortlist + tau at the new prices and run the exact
            # eps-CS violator scan in the same round.  (The kappa-cheap
            # phase start was measured catastrophically slower at 1M:
            # stale taus decertify en masse and flood the rescan backlog
            # -- 180 full-width rounds/phase; PERF.md.)  Fresh taus make
            # in-phase certification the common case, which is where the
            # kappa-gather savings live.
            ids0 = jnp.full((n,), n, jnp.int32)
            backlog0 = jnp.where(nvalid > 0, all_rows, jnp.int32(n))
            (scpack, prices, owner, sigma, ids, backlog, n_won, n_evi,
             n_resc) = candidate_round(
                rowpack, scpack, prices, owner, sigma,
                ids0, backlog0, st.eps, bigp, kappa=kappa, resc_cap=n,
                phase_start=True)
            rescans = st.rescans + n_resc
        rounds = st.rounds + 1
        active = count_active(ids, backlog)
        (scpack, prices, owner, sigma, ids, backlog, active, rounds,
         rescans, ladder_rounds) = ladder(
            scpack, prices, owner, sigma, ids, backlog,
            active, rounds, rescans, st.eps)
        tier_rounds = st.tier_rounds.at[0].add(1)
        tier_rounds = tier_rounds.at[1:].add(ladder_rounds)
        return st._replace(
            prices=prices, owner=owner, sigma=sigma,
            sc_cols=scpack[:, :kappa],
            sc_vals=_bits_to(scpack[:, kappa:2 * kappa], dtype),
            sc_tau=_bits_to(scpack[:, 2 * kappa], dtype),
            rounds=rounds, phases=st.phases + 1, rescans=rescans,
            tier_rounds=tier_rounds)

    init = CandState(
        prices=p0.astype(dtype),
        owner=jnp.full((m,), -1, jnp.int32),
        sigma=jnp.full((n,), -1, jnp.int32),
        sc_cols=jnp.zeros((n, kappa), jnp.int32),
        sc_vals=jnp.full((n, kappa), neg, dtype),
        sc_tau=jnp.full((n,), neg, dtype),
        eps=eps0,
        rounds=jnp.int32(0),
        phases=jnp.int32(0),
        rescans=jnp.int32(0),
        tier_rounds=jnp.zeros((len(tiers) + 1,), jnp.int32),
    )
    st = run_phase(init, first=True)

    def outer_cond(carry):
        st, done = carry
        return jnp.logical_not(done)

    def outer_body(carry):
        st, _ = carry
        new_eps = _auction._next_eps(st.eps, theta, eps_min)
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
