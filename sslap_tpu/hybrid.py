"""Hybrid device+host auction solve (performance path for single large
instances).

Why this exists: the Jacobi auction retires most rows in a handful of wide
rounds, but the tail of every eps phase is *serial eviction chains*:
counted on random sparse instances, ~82% of rounds carry fewer than 16
bids (serial work where one host core wins) while <1% of rounds carry
>45% of all bids (wide data-parallel work where the device wins).

Square-problem flow (the headline path):

  device, ONE jit execution: every eps phase's wide rounds via tiered
      active-compaction (compact.solve_ell_tiered), each phase *truncated*
      once <= ``trunc`` rows are active -- correct because only the final
      phase must complete at eps_min; earlier phases just precondition
      prices (eps-CS holds throughout);
  one device->host transfer (prices + sigma; owner is derived), so no
      per-phase state crosses the host-device link;
  host, ONE native C++ Gauss-Seidel pass (sslap_native.cpp) at eps_min:
      finishes the serial chains with bid semantics identical to the
      device (lowest-column argmax tie-break, v2 = v1 - bigp single-entry
      rule), preserving eps-CS at handoff.

Rectangular problems keep the per-phase device/host split with implicit
dummy handling.  ``mode='cpu'`` skips the device entirely: a pure native
Gauss-Seidel eps-scaled solve -- the sslap-class CPU reference used by
bench.py as the vs-baseline.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from sslap_tpu import auction as _auction
from sslap_tpu.ingest import ELLProblem

try:
    from sslap_tpu.native import auction_gs as _gs_native
    from sslap_tpu.native import unassign_violators_native as _unassign_native
except Exception:  # pragma: no cover
    _gs_native = None
    _unassign_native = None

if _gs_native is not None:
    _gs, _unassign = _gs_native, _unassign_native
else:
    # No toolchain: pure-numpy engine (same bid semantics, ~30x slower).
    # Keeps float64 / cpu-mode solves working without g++ (gs_host.py).
    from sslap_tpu.gs_host import (
        auction_gs_numpy as _gs,
        unassign_violators_numpy as _unassign,
    )


def tail_bid_budget(n: int) -> int:
    """Bid budget of the eps_min host tail that finishes a truncated
    device pass; exhausting it reports the solve as not found."""
    return 100 * n + 10_000_000


def native_available() -> bool:
    """True when the fast native (C++) engine is loaded.  The numpy
    fallback keeps ``mode='cpu'`` functional either way, but ``auto``
    routing should only prefer the CPU when it is the native one."""
    return _gs_native is not None


def ell_to_csr_transformed(prob: ELLProblem, sign: int, scale: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host CSR of transformed (maximization) values, matching the device's
    ``Transform.apply`` arithmetic exactly (same dtype)."""
    valid = np.asarray(prob.valid)
    cols = np.asarray(prob.cols)
    vals = np.asarray(prob.vals)
    from sslap_tpu.native import ell_to_csr_native
    if ell_to_csr_native is not None:
        out = ell_to_csr_native(cols, vals, valid,
                                vals.dtype.type(sign * scale),
                                int(valid.sum()))
        if out is not None:
            return out
    counts = valid.sum(axis=1).astype(np.int64)
    indptr = np.zeros(prob.n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = cols[valid].astype(np.int32)
    data = (vals[valid] * np.asarray(sign * scale, vals.dtype)).astype(
        vals.dtype)
    return indptr, indices, data


def _compact_mod():
    from sslap_tpu import compact as _compact
    return _compact


@functools.partial(jax.jit, static_argnames=("tail_phases", "tiers"))
def _device_rowpack_solve(rowpack, nvalid, p0, eps0, eps_min, theta,
                          max_iter, bigp, trunc, theta_tail,
                          wide_layout=None, tail_phases=2, tiers=None):
    """Truncated tiered solve over a pre-packed (and possibly device-
    cached) RowPack -- the square hybrid's production entry.

    ``theta_tail`` is a traced scalar; <= 1 keeps the pure-theta descent
    (see auction._next_eps's mixed tail schedule).  ``wide_layout`` (a
    widebid.WideLayout pytree or None) switches the phase-start rounds
    to the window-gather formulation.  ``tiers`` (static tuple or None
    for default_tiers(n)) selects the ladder -- bit-identical results
    for any ladder, see compact.default_tiers.
    """
    res, st = _compact_mod().solve_rowpack_tiered(
        rowpack, nvalid, p0, eps0, eps_min, theta, max_iter,
        bigp=bigp, trunc=trunc, theta_tail=theta_tail,
        tail_phases=tail_phases, wide_layout=wide_layout, tiers=tiers)
    return res, st.tier_rounds


@functools.partial(jax.jit, static_argnames=("engine",))
def _device_truncated_solve(cols, vals_t, valid, nvalid, p0,
                            eps0, eps_min, theta, max_iter, bigp, trunc,
                            theta_tail=0.0, engine: str = "compact"):
    """All eps phases on device in ONE execution, each truncated at
    ``trunc`` active rows, so the hybrid pays exactly one host->device and
    one device->host transfer.

    ``engine``: 'compact' (exact-scan rounds, compact.solve_ell_tiered) or
    'candidates' (kappa-shortlist rounds at wide tiers,
    candidate.solve_ell_candidates -- ~(K/kappa)x fewer gathers per wide
    round)."""
    if engine == "candidates":
        from sslap_tpu import candidate as _candidate
        res, st = _candidate.solve_ell_candidates(
            cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta,
            max_iter, bigp=bigp, trunc=trunc)
        return res, st.tier_rounds
    from sslap_tpu import compact as _compact
    res, st = _compact.solve_ell_tiered(cols, vals_t, valid, nvalid, p0,
                                        eps0, eps_min, theta, max_iter,
                                        bigp=bigp, trunc=trunc,
                                        theta_tail=theta_tail)
    return res, st.tier_rounds


@functools.partial(jax.jit, static_argnames=("n_dummy",))
def _device_phase(cols, vals_t, valid, nvalid, prices, owner, sigma,
                  eps, bigp, threshold, max_rounds, n_dummy):
    """Jacobi rounds at fixed eps until <= threshold active rows remain (or
    everything is assigned / round budget spent)."""
    eps = jnp.asarray(eps, vals_t.dtype)
    bigp = jnp.asarray(bigp, vals_t.dtype)

    def active(sigma, owner):
        a = jnp.sum((sigma < 0) & (nvalid > 0)).astype(jnp.int32)
        if n_dummy > 0:
            a = a + _auction.count_unassigned_dummies(owner, n_dummy)
        return a

    def cond(carry):
        prices, owner, sigma, rounds = carry
        return (active(sigma, owner) > threshold) & (rounds < max_rounds)

    def body(carry):
        prices, owner, sigma, rounds = carry
        prices, owner, sigma = _auction.jacobi_round(
            cols, vals_t, valid, nvalid, prices, owner, sigma, eps, bigp)
        if n_dummy > 0:
            prices, owner, sigma, _ = _auction.dummy_grab_step(
                prices, owner, sigma, eps, n_dummy)
        return prices, owner, sigma, rounds + 1

    prices, owner, sigma, rounds = lax.while_loop(
        cond, body, (prices, owner, sigma, jnp.int32(0)))
    return prices, owner, sigma, rounds, active(sigma, owner)




def _csr_to_csc(indptr, indices, data, n, m):
    """Column-major twin of the host CSR (for the reverse passes of the
    FR engine).  One stable argsort + gathers; built once per solve and
    cached next to the CSR in device_cache."""
    rows_flat = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices[:rows_flat.shape[0]], kind="stable")
    cindices = rows_flat[order].astype(np.int32)
    cvals = np.ascontiguousarray(np.asarray(data)[order])
    counts = np.bincount(np.asarray(indices), minlength=m)
    cindptr = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=cindptr[1:])
    return cindptr, cindices, cvals


def _run_gs(indptr, indices, data, prices, sigma, owner, eps, bigp,
            n_dummy, budget, csc=None, profits=None):
    """Dispatch one host finisher pass: the combined forward-reverse
    engine when a CSC is supplied (square only), else the forward GS."""
    if csc is not None and n_dummy == 0:
        from sslap_tpu.native.build import auction_gs_fr
        cindptr, cindices, cvals = csc
        return auction_gs_fr(indptr, indices, data, cindptr, cindices,
                             cvals, prices, profits, sigma, owner,
                             eps, bigp, budget)
    return _gs(indptr, indices, data, prices, sigma, owner, eps, bigp,
               n_dummy, budget)


def _finish_square_fast_path(res, tier_rounds, prob, indptr, indices, data,
                             prices, sigma, owner, e_min, bigp, tr, n, mode,
                             t0, t_dev0, csc=None):
    """Shared tail of the square hybrid: read back device state, run the
    native GS finisher at eps_min, build the meta dict (honest optimality
    accounting -- see inline comments)."""
    # Split device completion from the host readback: all outputs of the
    # jitted solve materialize on device together, so blocking on the
    # 4-byte rounds scalar marks the end of device COMPUTE; the [n]
    # prices/sigma fetch then runs under its own clock
    # (meta['readback_time']).
    jax.block_until_ready(res.rounds)
    t_dev = time.perf_counter() - t_dev0
    # ONE batched fetch for everything the host tail needs, instead of
    # one device round-trip per array and bookkeeping scalar.
    t_rb0 = time.perf_counter()
    prices, sigma, dev_rounds, dev_final_eps, dev_phases, tier_rounds = \
        jax.device_get((res.prices, res.sigma, res.rounds,
                        res.final_eps, res.phases, tier_rounds))
    dev_rounds = int(dev_rounds)
    # device_get may hand back read-only buffers; the native GS finisher
    # mutates prices/sigma in place, so take writable host copies (~ms).
    prices = np.array(prices)
    sigma = np.array(sigma)
    t_readback = time.perf_counter() - t_rb0
    # owner is derivable from sigma for square problems (no dummies).
    owner[:] = -1
    assigned = sigma >= 0
    owner[sigma[assigned]] = np.nonzero(assigned)[0].astype(np.int32)
    t_gs0 = time.perf_counter()
    bids = _run_gs(indptr, indices, data, prices, sigma, owner,
                   e_min, bigp, 0, tail_bid_budget(n), csc=csc,
                   profits=(np.zeros(n, prices.dtype)
                            if csc is not None else None))
    t_gs = time.perf_counter() - t_gs0
    unassigned = int(((sigma < 0) & (np.diff(indptr) > 0)).sum())
    # Honest optimality accounting: the eps_min-CS guarantee only holds
    # if the device pass actually descended to eps_min (its final
    # phase's violator scan re-auctions stale pairs).  If it exited on
    # the round budget at eps > eps_min, the host GS still completes the
    # assignment, but earlier-assigned pairs are only final_eps-CS.
    dev_eps = float(dev_final_eps)
    # Compare in the DEVICE dtype: e_min is host float64 and the f32
    # device eps may round a hair above it, which must not read as
    # "never reached eps_min".
    eps_reached = bool(np.asarray(dev_final_eps)
                       <= np.asarray(e_min, data.dtype))
    meta = {
        "its": dev_rounds,
        "host_bids": max(int(bids), 0),
        "phases": int(dev_phases),
        "final_eps": (float(e_min) if eps_reached else dev_eps) / tr.scale,
        "unassigned": unassigned,
        "soln_found": unassigned == 0 and bids >= 0 and eps_reached,
        "time": time.perf_counter() - t0,
        "device_time": t_dev,
        "readback_time": t_readback,
        "host_gs_time": t_gs,
        "tier_rounds": np.asarray(tier_rounds).tolist(),
        "mode": mode,
    }
    return sigma, prices, meta

def solve_hybrid(
    prob: ELLProblem,
    *,
    problem: str = "min",
    eps_start=None,
    eps_min=None,
    theta: Optional[float] = None,
    theta_tail: Optional[float] = None,
    tail_phases: int = 2,
    max_iter: Optional[int] = None,
    threshold: int = 4096,
    trunc: int = 256,
    mode: str = "hybrid",            # 'hybrid' | 'cpu'
    warm_prices=None,
    n_real: Optional[int] = None,
    keep_assignment: bool = True,
    engine: str = "compact",         # square device engine (see
                                     # _device_truncated_solve)
    device_cache: Optional[dict] = None,
    wide_rounds: Optional[bool] = None,
    fine_ladder: Optional[bool] = None,
    warm_fr: int = 0,
    gs_engine: str = "auto",         # 'auto' | 'forward' | 'fr'
):
    """eps-scaled solve with device bulk + host tail (or pure host).

    ``trunc`` is the square fast path's per-phase active-row truncation
    point (the device leaves <= trunc rows per phase for the host GS;
    256 was chosen on the earlier accelerator and is not yet measured on
    the H100);
    ``threshold`` plays the same role for the rectangular per-phase path
    only -- the square path does not consult it.

    Returns (sigma [n] numpy int32, prices numpy, meta dict with device
    'its' rounds and 'host_bids')."""
    n, m = prob.n, prob.m
    n_real = n if n_real is None else n_real
    n_dummy = m - n_real
    if theta is None:
        # theta=None -> per-mode, size-aware default (see
        # auction.device_theta_default); the CPU engine keeps the
        # sslap-class 5.
        theta = (_auction.device_theta_default(n)
                 if mode == "hybrid" and m - n_real == 0
                 else _auction.HOST_THETA)
    if theta_tail is None:
        # Mixed tail schedule default (PERF.md round-3 theta A/B): the
        # host-GS tail bid count is set by the FINAL eps drop ratio --
        # theta=10 end-to-end blew one 1M instance's tail to 8.7M bids
        # where ratio-3 final drops hold it near 1-3M, for ~2 extra cheap
        # phase starts.  Only engaged where the aggressive device theta
        # is (large square hybrids); the host path keeps the sslap-class
        # pure schedule.
        theta_tail = (3.0 if (mode == "hybrid" and m - n_real == 0
                              and float(theta) > 5)
                      else 0.0)
    vals_np = np.asarray(prob.vals)
    valid_np = np.asarray(prob.valid)
    dtype = vals_np.dtype
    vmax_abs = float(np.abs(vals_np[valid_np]).max()) if valid_np.any() else 0.0
    tr = _auction.make_transform(problem, m, dtype, vmax_abs,
                                 int_exact=prob.int_exact)
    e0, e_min, theta_v = _auction.default_eps_schedule(
        dtype, vmax_abs, m, tr.scale,
        eps_min=eps_min, eps_start=eps_start, theta=theta,
        int_exact=prob.int_exact)
    if max_iter is None:
        max_iter = _auction.default_max_iter(n)

    csr_key = ("csr", tr.sign, tr.scale)
    if device_cache is not None and device_cache.get("csr_key") == csr_key:
        indptr, indices, data = device_cache["csr"]
    else:
        indptr, indices, data = ell_to_csr_transformed(prob, tr.sign,
                                                       tr.scale)
        if device_cache is not None:
            device_cache.update(csr_key=csr_key,
                                csr=(indptr, indices, data))
    # Combined forward-reverse finisher (round 5): square + native only;
    # anything else silently keeps the forward engine (rect keeps the
    # heap-based dummy path, numpy-fallback hosts have no FR entry).
    # 'auto' resolves to FR exactly where it was found decisive: the
    # SQUARE HYBRID's eps_min tail, whose truncated phases leave the
    # long-eviction-chain regime reverse bids crush (at 1M: 906,648 tail
    # bids vs the forward tail's 5.05M, same objective to 1.6e-9).
    # mode='cpu' stays forward -- it is the sslap-class reference engine
    # bench.py measures AGAINST, and must keep reference semantics.
    if gs_engine == "auto":
        gs_engine = ("fr" if (mode == "hybrid" and n == m
                              and n_dummy == 0 and native_available())
                     else "forward")
    csc = None
    if gs_engine == "fr" and n == m and native_available():
        if device_cache is not None and \
                device_cache.get("csc_key") == csr_key:
            csc = device_cache["csc"]
        else:
            csc = _csr_to_csc(indptr, indices, data, n, m)
            if device_cache is not None:
                device_cache.update(csc_key=csr_key, csc=csc)
    if valid_np.any():
        tmax, tmin = data.max(), data.min()
        bigp = (tmax - tmin) + (1 if np.issubdtype(dtype, np.integer) else 1.0)
    else:
        bigp = 1
    is_int = np.issubdtype(dtype, np.integer) or prob.int_exact

    prices = np.zeros(m, dtype) if warm_prices is None else \
        np.array(warm_prices, dtype)
    if warm_prices is not None and warm_fr > 0:
        # Forward-reverse dual tightening (round 5): repair warm prices
        # that sit ABOVE the new instance's market level -- the forward
        # auction's structural warm-start hard case (prices only rise).
        # Two O(nnz) passes per sweep over the already-built CSR.
        _auction.fr_tighten(indptr, indices, data, prices, iters=warm_fr)
    sigma = np.full(n, -1, np.int32)
    owner = np.full(m, -1, np.int32)

    use_device = mode == "hybrid"
    if use_device and n_dummy == 0 and engine == "compact":
        # Square fast path: every eps phase runs on device in one jit call,
        # truncated at ``trunc`` active rows; a single native GS pass at
        # eps_min then finishes the assignment.  Correct because only the
        # FINAL phase must complete at eps_min (eps-CS holds throughout);
        # truncated phases just precondition prices.  Counted split
        # (n = 20k, 10 nnz/row): ~82% of rounds carry < 16 bids (host's
        # serial regime), while < 1% of rounds carry > 45% of bids
        # (device's wide regime).
        #
        # The per-row data ships as the host-packed RowPack (ONE array)
        # and is cached device-side across solves via ``device_cache``
        # (an AuctionSolver-owned dict): re-solves with warm prices /
        # repeated instances skip the host-to-device transfer.
        t0 = time.perf_counter()
        t_dev0 = t0
        trunc_static = min(int(trunc), max(n // 8, 1))
        trunc = jnp.int32(trunc_static)
        # Ladder choice: prune tiers at/below the static trunc (never
        # entered -- a phase truncates once active <= trunc) and spend the
        # freed program size on fine {2^k, 3*2^(k-1)} interleaving below
        # 32768.  Bit-identical results for any ladder
        # (compact.default_tiers docstring).  fine_ladder=None defers to
        # SSLAP_TPU_FINE_LADDER (default on; chosen on the earlier
        # accelerator, not yet measured on the H100).
        if fine_ladder is None:
            fine_ladder = os.environ.get(
                "SSLAP_TPU_FINE_LADDER", "1") == "1"
        tiers_static = _compact_mod().default_tiers(
            n, fine=bool(fine_ladder), floor=trunc_static)
        # The cache dict is owned by ONE AuctionSolver bound to one
        # problem; shape/transform fields in the key catch accidental
        # reuse across differently-shaped problems (same-shape different
        # data is the caller's contract to avoid).
        cache_key = (tr.sign, tr.scale, str(dtype), n, m, prob.K,
                     prob.nnz)
        if device_cache is not None and \
                device_cache.get("key") == cache_key:
            rowpack_dev = device_cache["rowpack"]
            nvalid_dev = device_cache["nvalid"]
        else:
            # One fused native pass: transform + sentinel mask + pack
            # (no [n, K] vals_t temporary).
            rp = _compact_mod().np_build_rowpack(
                np.asarray(prob.cols), vals_np, valid_np,
                np.asarray(prob.nvalid), sign_scale=tr.sign * tr.scale)
            rowpack_dev = jax.device_put(rp)
            nvalid_dev = jax.device_put(np.asarray(prob.nvalid))
            if device_cache is not None:
                device_cache.update(key=cache_key, rowpack=rowpack_dev,
                                    nvalid=nvalid_dev)
        # Window-gather phase starts (ops/widebid.py), bit-identical to
        # the scalar-gather rounds.  None (auto) resolves to off: on the
        # H100 the plain gather round beat it at 1M (PERF.md).
        wide_dev = None
        if wide_rounds:
            if device_cache is not None and \
                    device_cache.get("wide_key") == cache_key:
                wide_dev = device_cache["wide"]
            else:
                from sslap_tpu.ops.widebid import build_wide_layout
                neg_np = _auction.neg_sentinel_np(dtype)
                lay = build_wide_layout(
                    np.asarray(prob.cols), vals_np, valid_np, m,
                    sign_scale=tr.sign * tr.scale, neg=neg_np)
                # None = skew guard refused the layout (a degenerate
                # column window would blow the padding up); the scalar
                # rounds carry those instances.
                wide_dev = None if lay is None else jax.device_put(lay)
                if device_cache is not None:
                    device_cache.update(wide_key=cache_key, wide=wide_dev)
        res, tier_rounds = _device_rowpack_solve(
            rowpack_dev, nvalid_dev, jnp.asarray(prices), e0, e_min,
            theta_v, max_iter, bigp, trunc,
            jnp.asarray(theta_tail, jnp.asarray(e0).dtype),
            wide_layout=wide_dev, tail_phases=tail_phases,
            tiers=tiers_static)
        return _finish_square_fast_path(
            res, tier_rounds, prob, indptr, indices, data, prices, sigma,
            owner, e_min, bigp, tr, n, mode, t0, t_dev0, csc=csc)
    if use_device and n_dummy == 0:
        # Non-default square engines (e.g. engine='candidates') keep the
        # ELL-argument entry; they build their own packs in-jit.
        vals_t = tr.apply(prob.vals)
        t0 = time.perf_counter()
        t_dev0 = t0
        trunc = jnp.int32(min(int(trunc), max(n // 8, 1)))
        res, tier_rounds = _device_truncated_solve(
            prob.cols, vals_t, prob.valid, prob.nvalid,
            jnp.asarray(prices), e0, e_min, theta_v, max_iter,
            bigp, trunc, jnp.asarray(0.0, jnp.asarray(e0).dtype),
            engine=engine)
        return _finish_square_fast_path(
            res, tier_rounds, prob, indptr, indices, data, prices, sigma,
            owner, e_min, bigp, tr, n, mode, t0, t_dev0, csc=csc)

    if use_device:
        vals_t = tr.apply(prob.vals)
        d_prices = jnp.asarray(prices)

    profits = np.zeros(n, dtype) if csc is not None else None
    eps = max(e0, e_min)
    total_rounds = 0
    total_bids = 0
    phases = 0
    t0 = time.perf_counter()
    # Bids-per-phase safety valve.  Scale with the TOTAL bidder count --
    # real rows AND implicit dummies: a rectangular phase runs (m - n)
    # dummy grabs plus their real-row evictions, so an n-scaled budget
    # falsely tripped at 100k x 200k (round 5: one unassigned row left at
    # final_eps 0.32, soln_found honest-false, ~2.6M bids/phase).
    host_budget = 50 * (n + n_dummy) + 100_000

    first_phase = True
    while True:
        if not first_phase and keep_assignment:
            # Warm-started eps-scaling: keep the previous phase's assignment
            # except eps-CS violators for the new eps (matches the device
            # path's auction.py:unassign_violators; ~neutral on total bids
            # for random instances -- see PERF.md -- but kept for semantic
            # parity with the device paths and for warm-start workloads).
            _unassign(indptr, indices, data, prices, sigma, owner, eps,
                      n_dummy)
        elif not first_phase:
            sigma[:] = -1
            owner[:] = -1
        first_phase = False
        if use_device:
            # Only the rectangular (implicit-dummy) hybrid reaches this
            # loop; square problems took the truncated fast path above.
            d_sigma = jnp.asarray(sigma)
            d_owner = jnp.asarray(owner)
            d_prices, d_owner, d_sigma, rounds, _ = _device_phase(
                prob.cols, vals_t, prob.valid, prob.nvalid,
                d_prices, d_owner, d_sigma, eps, bigp,
                jnp.int32(threshold),
                jnp.int32(max(max_iter - total_rounds, 0)), n_dummy)
            total_rounds += int(rounds)
            prices = np.array(d_prices)      # host copies for the GS tail
            sigma = np.array(d_sigma)
            owner = np.array(d_owner)
        bids = _run_gs(indptr, indices, data, prices, sigma, owner,
                       eps, bigp, n_dummy, host_budget, csc=csc,
                       profits=profits)
        if bids < 0:
            break  # bid budget exhausted: likely infeasible
        total_bids += bids
        phases += 1
        if eps <= e_min or total_rounds >= max_iter:
            break
        if use_device:
            d_prices = jnp.asarray(prices)
        eps = max(eps // theta_v, e_min) if is_int else max(eps / theta_v,
                                                            e_min)

    unassigned = int(((sigma < 0) &
                      (np.diff(indptr) > 0)).sum())
    if n_dummy > 0:
        unassigned += n_dummy - int((owner == -2).sum())
    meta = {
        # 'its' = iteration count in the reference's sense: device Jacobi
        # rounds when the device participated, else the GS engine's bids
        # (the pure-CPU path has no rounds; its=0 would misread as "no
        # work").
        "its": total_rounds if use_device else total_bids,
        "host_bids": total_bids,
        "phases": phases,
        "final_eps": float(eps) / tr.scale,
        "unassigned": unassigned,
        # Same optimality standard as the square fast path: a complete
        # assignment that exited on max_iter at eps > eps_min is only
        # eps-CS at that larger eps and must not read as optimal.
        "soln_found": (unassigned == 0
                       and int((sigma[:n_real] < 0).sum()) == 0
                       and eps <= e_min),
        "time": time.perf_counter() - t0,
        "mode": mode,
    }
    return sigma, prices, meta
