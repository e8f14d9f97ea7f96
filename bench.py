"""Primary benchmark: the 1M x 1M sparse LAP on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
...} with the device it ran on; diagnostics go to stderr.  Exits non-zero
when JAX finds no GPU -- a CPU run is never reported as a device number.

Primary metric (BASELINE.md): end-to-end time-to-optimal on the 1M x 1M,
~10 nnz/row float sparse LAP (config 4), reported as nnz/s of useful edge
throughput = nnz / solve_time for the hybrid path (device bulk + native
host tail).

vs_baseline: speedup in time-to-optimal over the sslap-class CPU reference
-- this repo's own native Gauss-Seidel auction (mode='cpu'), the same
algorithm family as the reference, measured on the same instance.  (The
actual sslap is unavailable: empty reference mount, see BASELINE.md.)

    python bench.py               # 1M x 1M
    BENCH_SMALL=1 python bench.py # 50k x 50k
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_instance(n, m, k_extra, seed=0, low=1.0, high=1000.0,
                  integer=False):
    """k_extra random entries per row plus a planted random matching (so
    the instance is feasible), duplicates removed; rows come out sorted.
    Float costs in [low, high), or integers with ``integer=True``."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), k_extra)
    cols = rng.integers(0, m, n * k_extra, dtype=np.int64)
    perm = rng.permutation(m)[:n].astype(np.int64)
    rr = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cc = np.concatenate([cols, perm])
    key = rr * m + cc
    _, idx = np.unique(key, return_index=True)
    rr, cc = rr[idx], cc[idx]
    if integer:
        vv = rng.integers(int(low), int(high), rr.shape[0]).astype(np.int32)
    else:
        vv = (rng.random(rr.shape[0]) * (high - low) + low).astype(
            np.float32)
    return rr, cc, vv


def card_info() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def smoke_device_exact():
    """Tiny device-mode exact-vs-oracle gate: catches device lowering
    regressions before the long bench runs."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa
    from sslap_tpu import auction_solve
    rng = np.random.default_rng(7)
    C = rng.integers(1, 1000, (256, 256))
    res = auction_solve(C, mode="device", cardinality_check=False)
    r, c = scipy_lsa(C)
    if res["meta"]["obj"] != int(C[r, c].sum()):
        raise RuntimeError("device smoke: objective != scipy optimum")
    log("device 256x256 smoke: exact vs scipy OK")


def main():
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        log(f"bench: needs a GPU, JAX found {devices[0].platform!r}")
        return 2
    from sslap_tpu.utils import enable_compile_cache
    enable_compile_cache()
    card = card_info()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices),
              "card": card}
    log(f"device: {device}")
    smoke_device_exact()
    small = os.environ.get("BENCH_SMALL")
    n = 50_000 if small else 1_000_000
    rr, cc, vv = make_instance(n, n, 9, seed=0)
    nnz = rr.shape[0]
    loc = np.stack([rr, cc], 1)
    log(f"instance: {n}x{n}, nnz={nnz} ({nnz/n:.2f}/row)")

    from sslap_tpu import AuctionSolver

    # CPU reference (sslap-class Gauss-Seidel, single thread), measured
    # under the SAME construct-once serving pattern as the hybrid
    # (steady-state vs steady-state).  Host speed drifts run to run, so
    # the reference is several steady-state reps -> TRIMMED median (drop
    # the single worst outlier, median the rest) with per-rep load
    # averages and hypervisor steal recorded so a contaminated run is
    # visible in the log.
    solver_cpu = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="cpu",
                               cardinality_check=False)
    res_cpu = solver_cpu.solve()                 # warm: ingest + CSR cached
    cpu_reps = int(os.environ.get("BENCH_CPU_REPS", "7"))

    def _steal_jiffies():
        # /proc/stat field 8 = hypervisor steal, which loadavg cannot see.
        try:
            with open("/proc/stat") as f:
                parts = f.readline().split()
            return int(parts[8]) if len(parts) > 8 else 0
        except (OSError, ValueError):
            return 0

    def cpu_rep():
        nonlocal res_cpu
        load0 = os.getloadavg()[0]
        st0 = _steal_jiffies()
        t0 = time.perf_counter()
        res_cpu = solver_cpu.solve()
        dt = time.perf_counter() - t0
        cpu_times.append(dt)
        cpu_loads.append(round(max(load0, os.getloadavg()[0]), 2))
        # jiffy = 10 ms at USER_HZ=100; report steal as % of the rep wall
        cpu_steals.append(round((_steal_jiffies() - st0) / 100.0 / dt * 100,
                                1))
        return dt

    def cpu_summary():
        # Trimmed median: steal-time contamination is one-sided (reps only
        # get SLOWER under load), so drop the max before the median.
        trimmed = sorted(cpu_times)[:-1] if len(cpu_times) > 2 else cpu_times
        cpu_t = float(np.median(trimmed))
        log(f"cpu (sslap-class GS, steady-state x{len(cpu_times)}): "
            f"trimmed median {cpu_t:.2f}s band [{min(cpu_times):.2f}, "
            f"{max(cpu_times):.2f}]s loadavg/rep={cpu_loads} "
            f"steal%/rep={cpu_steals} "
            f"bids={res_cpu['meta']['host_bids']} "
            f"obj={res_cpu['meta']['obj']:.1f}")
        return cpu_t

    cpu_times, cpu_loads, cpu_steals = [], [], []
    cpu_rep()                                    # pair 0's CPU half

    # Hybrid path: construct-once solver (ingest + device transfer paid
    # once -- the production serving pattern), warm the compile, then time
    # steady-state solves INTERLEAVED with the remaining CPU reps, so each
    # per-pair cpu_i/hyb_i ratio samples both engines in the same host
    # regime; their median is the reported vs_baseline.
    t0 = time.perf_counter()
    solver = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="hybrid",
                           cardinality_check=False)
    res_h = solver.solve()                       # compile + transfer warmup
    setup_s = time.perf_counter() - t0
    hyb_times = []
    for i in range(cpu_reps):
        t0 = time.perf_counter()
        res_h = solver.solve()
        hyb_times.append(time.perf_counter() - t0)
        if i + 1 < cpu_reps:
            cpu_rep()                            # pair i+1's CPU half
    cpu_t = cpu_summary()
    ratios = [c / h for c, h in zip(cpu_times, hyb_times)]
    hyb_t = float(np.median(hyb_times))
    meta = res_h["meta"]
    log(f"hybrid (steady-state x{len(hyb_times)}): median {hyb_t:.2f}s "
        f"band [{min(hyb_times):.2f}, {max(hyb_times):.2f}]s "
        f"setup {setup_s:.2f}s device_rounds={meta['its']} "
        f"host_bids={meta['host_bids']} obj={meta['obj']:.1f} "
        f"device_t={meta['device_time']:.2f}s "
        f"readback_t={meta['readback_time']:.2f}s "
        f"host_gs_t={meta['host_gs_time']:.2f}s")
    log(f"tier_rounds (phase-start, then ladder tiers): "
        f"{meta['tier_rounds']}")
    if not meta["soln_found"]:
        raise RuntimeError("hybrid solve did not reach an optimal solution")
    rel_gap = abs(meta["obj"] - res_cpu["meta"]["obj"]) / abs(
        res_cpu["meta"]["obj"])
    log(f"objective agreement cpu vs hybrid: rel gap {rel_gap:.2e}")
    # Hard gate: both engines solve the same float32 instance to
    # eps-optimality; disagreement beyond f32 accumulation noise means a
    # correctness regression, and no headline is recorded over one.
    if rel_gap >= 1e-6:
        raise RuntimeError(f"cpu-vs-hybrid objective rel gap {rel_gap:.2e}")

    device_s = meta["device_time"]
    # vs_baseline: median of the PAIRED per-rep cpu_i/hyb_i ratios; band =
    # [min, max] of the pair ratios.  device_pass_nnz_per_s: nnz over the
    # device-pass seconds, immune to host-speed drift of the CPU baseline.
    print(json.dumps({
        "metric": "time_to_optimal_1Mx1M_sparse_lap_nnz_per_s",
        "value": nnz / hyb_t,
        "unit": "nnz/s",
        "vs_baseline": float(np.median(ratios)),
        "vs_baseline_band": [min(ratios), max(ratios)],
        "device": device,
        "n": n,
        "nnz": int(nnz),
        "setup_s": setup_s,
        "cpu_steady_s": cpu_t,
        "cpu_steady_band": [min(cpu_times), max(cpu_times)],
        "cpu_loadavg_per_rep": cpu_loads,
        "cpu_steal_pct_per_rep": cpu_steals,
        "hyb_steady_s": hyb_t,
        "hyb_steady_band": [min(hyb_times), max(hyb_times)],
        "cpu_nnz_per_s": nnz / cpu_t,
        "device_s": device_s,
        "device_pass_nnz_per_s": nnz / device_s if device_s > 0 else None,
        "readback_s": meta["readback_time"],
        "host_gs_s": meta["host_gs_time"],
        "tier_rounds": meta["tier_rounds"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
