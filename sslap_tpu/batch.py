"""Batched independent LAP instances (T9; BASELINE config 3).

The reference has no batching (SURVEY.md SS1 'what sslap is not'); tracking/
matching workloads solve many small LAPs per frame, so here the whole
eps-scaled solve is vmapped over a leading instance axis.  JAX's while_loop
batching rule keeps iterating until *all* instances converge, masking
finished lanes -- exactly the semantics we want, with zero bespoke code in
the solver core.

Instances share one ELL shape [B, n, K]; ingest pads K across the batch
(``pad_to``).  Use ``batch_from_dense`` / ``batch_from_coo`` to build, or
stack ELLProblems with ``stack_problems``.
"""

from __future__ import annotations

import functools
import time
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from sslap_tpu import auction as _auction
from sslap_tpu import ingest as _ingest
from sslap_tpu.ingest import ELLProblem


def stack_problems(probs: Sequence[ELLProblem]) -> ELLProblem:
    """Stack same-shape instances into a batched ELLProblem [B, n, K]."""
    n, m = probs[0].n, probs[0].m
    K = max(p.K for p in probs)
    if any((p.n, p.m) != (n, m) for p in probs):
        raise ValueError("all instances in a batch must share (n, m)")

    def pad(a, k_axis, fill):
        a = np.asarray(a)
        padk = K - a.shape[k_axis]
        if padk == 0:
            return a
        width = [(0, 0)] * a.ndim
        width[k_axis] = (0, padk)
        return np.pad(a, width, constant_values=fill)

    cols = np.stack([pad(p.cols, 1, 0) for p in probs])
    vals = np.stack([pad(p.vals, 1, 0) for p in probs])
    valid = np.stack([pad(p.valid, 1, False) for p in probs])
    nvalid = np.stack([np.asarray(p.nvalid) for p in probs])
    return ELLProblem(cols=cols, vals=vals, valid=valid, nvalid=nvalid,
                      n=n, m=m,
                      int_exact=any(p.int_exact for p in probs))


def batch_from_dense(mats: np.ndarray, **kw) -> ELLProblem:
    mats = np.asarray(mats)
    if mats.ndim != 3:
        raise ValueError("expected [B, n, m] stack of dense matrices")
    K = mats.shape[2]
    return stack_problems([_ingest.from_dense(m, pad_to=None, **kw)
                           for m in mats])


@functools.partial(jax.jit, static_argnames=("n_global",))
def _batched_solve_jit(cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta,
                       max_iter, n_global):
    solve = functools.partial(_auction.solve_ell, n_global=n_global)
    return jax.vmap(
        solve,
        in_axes=(0, 0, 0, 0, 0, None, None, None, None),
    )(cols, vals_t, valid, nvalid, p0, eps0, eps_min, theta, max_iter)


def auction_solve_batched(
    prob: ELLProblem,
    problem: str = "min",
    eps_start=None,
    eps_min=None,
    theta: float = 5.0,
    max_iter: Optional[int] = None,
    warm_prices=None,
    mesh=None,
    batch_axis: str = "batch",
    chunk: Optional[int] = None,
    mode: str = "auto",
):
    """Solve a batch of independent instances; returns (sols [B, n] numpy,
    metas list).  Objectives are computed on host exactly (as in api.py).

    With ``mesh`` the batch axis is sharded over the mesh's ``batch_axis``
    (data parallelism over instances: each device runs the vmapped solve on
    its slice; no collectives are needed since instances are independent --
    the while_loop runs until the slowest local instance converges).

    ``chunk`` bounds how many instances run per device execution (default:
    whole batch, or 32 on single-device runs with B*n > ~10^6).  Chunking
    bounds each execution's device memory and lets the host overlap the
    next chunk's dispatch, at one dispatch per chunk.

    ``mode``: 'device' = the vmapped jitted solve; 'cpu' = the native
    Gauss-Seidel looped over instances; 'auto' picks cpu when the native
    toolchain is present and no mesh was given: the vmapped while runs
    every lane to the slowest lane's round count, and on the earlier
    accelerator the CPU engine won by two orders of magnitude at
    n=1024.  Not yet measured on the H100."""
    cols, vals, valid, nvalid = prob.cols, prob.vals, prob.valid, prob.nvalid
    if cols.ndim != 3:
        raise ValueError("expected batched ELLProblem with leading axis")
    B = cols.shape[0]
    t0 = time.perf_counter()
    if mode not in ("auto", "device", "cpu", "hybrid"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "hybrid":
        from sslap_tpu import dense_batch as _db
        if not _db.dense_hybrid_available(prob):
            raise ValueError(
                "batched hybrid needs square float/int32 instances with "
                "n <= 16384 and the native toolchain; use mode='cpu'")
        if mesh is not None:
            raise ValueError("batched hybrid is single-device; drop mesh=")
        return _db.solve_batched_dense_hybrid(
            prob, problem=problem, eps_start=eps_start, eps_min=eps_min,
            theta=theta, max_iter=max_iter, chunk=chunk)
    needs_host_precision = (np.dtype(np.asarray(vals).dtype) == np.float64
                            or prob.int_exact)
    if mode == "auto":
        from sslap_tpu import hybrid as _hybrid
        # float64/int_exact always resolves to cpu (the numpy gs_host
        # fallback works without the native toolchain, mirroring
        # api._resolve_mode) -- resolving to 'device' here would raise an
        # error telling the user to pass the mode they already passed.
        mode = "cpu" if ((_hybrid.native_available()
                          or needs_host_precision) and mesh is None) \
            else "device"
    if mode == "device" and needs_host_precision:
        # Mirrors api.AuctionSolver._resolve_mode: float64 / exact-large-int
        # batches cannot ride jit with x64 disabled (silent f32 downcast
        # would corrupt large integer costs).
        raise ValueError(
            "float64 / exact-large-integer batched costs are solved on the "
            "host path: use mode='cpu' (or 'auto', without mesh=) -- "
            "the device engines are f32/int32")
    if mode == "cpu":
        from sslap_tpu import hybrid as _hybrid
        sols = np.full((B, prob.n), -1, np.int32)
        metas = []
        for b in range(B):
            sub = ELLProblem(cols=np.asarray(cols[b]),
                             vals=np.asarray(vals[b]),
                             valid=np.asarray(valid[b]),
                             nvalid=np.asarray(nvalid[b]),
                             n=prob.n, m=prob.m,
                             int_exact=prob.int_exact)
            sol_b, _, meta_b = _hybrid.solve_hybrid(
                sub, problem=problem, eps_start=eps_start, eps_min=eps_min,
                theta=theta, max_iter=max_iter, mode="cpu",
                warm_prices=None if warm_prices is None else warm_prices[b])
            sols[b] = sol_b
            from sslap_tpu.api import _objective_host
            n_empty = int((np.asarray(sub.nvalid) == 0).sum())
            unassigned = meta_b["unassigned"] + n_empty
            metas.append(dict(meta_b, unassigned=unassigned,
                              soln_found=unassigned == 0,
                              obj=(_objective_host(sub, sol_b)
                                   if unassigned == 0 else None)))
        for mt in metas:
            mt["time"] = time.perf_counter() - t0
        return sols, metas
    if chunk is None and mesh is None and B * prob.n > 1_000_000 and B > 32:
        chunk = 32
    if chunk is not None and mesh is None and chunk < B:
        # Solve in bounded slices; concatenate results.
        sols_parts, metas = [], []
        for lo in range(0, B, chunk):
            hi = min(lo + chunk, B)
            sub = ELLProblem(cols=cols[lo:hi], vals=vals[lo:hi],
                             valid=valid[lo:hi], nvalid=nvalid[lo:hi],
                             n=prob.n, m=prob.m, int_exact=prob.int_exact)
            s_part, m_part = auction_solve_batched(
                sub, problem=problem, eps_start=eps_start, eps_min=eps_min,
                theta=theta, max_iter=max_iter,
                warm_prices=None if warm_prices is None
                else warm_prices[lo:hi], chunk=chunk, mode="device")
            sols_parts.append(s_part)
            metas.extend(m_part)
        return np.concatenate(sols_parts, axis=0), metas
    # Host copies FIRST: transform constants, objectives, and per-instance
    # metas all read these, and once the arrays are placed on a
    # process-spanning mesh they are no longer host-convertible.
    cols_np = np.asarray(cols)
    vals_np = np.asarray(vals)
    valid_np = np.asarray(valid)
    nvalid_np = np.asarray(nvalid)
    vmax_abs = float(np.abs(vals_np[valid_np]).max()) if valid_np.any() else 0.0
    tr = _auction.make_transform(problem, prob.m, vals_np.dtype, vmax_abs)
    e0, e_min, theta_v = _auction.default_eps_schedule(
        vals_np.dtype, vmax_abs, prob.m, tr.scale,
        eps_min=eps_min, eps_start=eps_start, theta=theta)
    if max_iter is None:
        max_iter = _auction.default_max_iter(prob.n)
    # Transform host-side (bit-identical to tr.apply's in-jit multiply) so
    # the mesh path can place the already-transformed values.
    vals_t = vals_np * np.asarray(tr.sign * tr.scale, vals_np.dtype)
    p0 = (np.zeros((B, prob.m), vals_np.dtype) if warm_prices is None
          else np.asarray(warm_prices, vals_np.dtype))
    args = (cols_np, vals_t, valid_np, nvalid_np, p0)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if B % mesh.shape[batch_axis] != 0:
            raise ValueError(
                f"batch size {B} must divide evenly over the "
                f"{mesh.shape[batch_axis]}-way '{batch_axis}' mesh axis")
        sh = NamedSharding(mesh, P(batch_axis))
        args = tuple(jax.device_put(a, sh) for a in args)
    res = _batched_solve_jit(*args, e0, e_min, theta_v, max_iter, prob.n)
    # Every per-instance result field is batch-sharded; fetch_global is a
    # process_allgather on multi-process meshes, plain np.asarray otherwise.
    from sslap_tpu.parallel.mesh import fetch_global
    sols = fetch_global(res.sigma)
    rounds_np = fetch_global(res.rounds)
    phases_np = fetch_global(res.phases)
    final_eps_np = fetch_global(res.final_eps)
    unassigned_np = fetch_global(res.unassigned)
    t1 = time.perf_counter()
    metas = []
    from sslap_tpu.api import _objective_host
    for b in range(B):
        sub = ELLProblem(cols=cols_np[b], vals=vals_np[b], valid=valid_np[b],
                         nvalid=nvalid_np[b], n=prob.n, m=prob.m,
                         int_exact=prob.int_exact)
        unassigned = (int(unassigned_np[b])
                      + int((nvalid_np[b] == 0).sum()))
        metas.append({
            "obj": _objective_host(sub, sols[b]) if unassigned == 0 else None,
            "its": int(rounds_np[b]),
            "phases": int(phases_np[b]),
            "soln_found": unassigned == 0,
            "final_eps": float(final_eps_np[b]) / tr.scale,
            "unassigned": unassigned,
            "time": t1 - t0,
        })
    return sols, metas
