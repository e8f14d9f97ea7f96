"""On-chip STEADY-STATE schedule A/B at the 1M headline instance.

One construct-once AuctionSolver per schedule variant (device cache warm,
compile shared -- theta and theta_tail are traced scalars, so every
variant reuses ONE executable), >= 2 steady-state reps, wall split
reported per variant.

Decides: device_theta_default / theta_tail default at headline scale.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sslap_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    import bench
    from sslap_tpu import AuctionSolver

    n = int(os.environ.get("AB_N", "1000000"))
    # >= 3 so the median is a real middle draw, not a 2-sample mean
    # (ADVICE r3); reps < 1 would NameError on the post-loop `res`.
    reps = max(int(os.environ.get("AB_REPS", "3")), 1)
    rr, cc, vv = bench.make_instance(n, n, 9, seed=0)
    loc = np.stack([rr, cc], 1)

    variants = [
        ("theta10_tail3", dict(theta=10.0, theta_tail=3.0)),   # shipped
        ("theta10_pure", dict(theta=10.0, theta_tail=0.0)),    # round-2
        ("theta3_pure", dict(theta=3.0, theta_tail=0.0)),      # sweep best
        ("theta5_pure", dict(theta=5.0, theta_tail=0.0)),
    ]
    for name, kw in variants:
        solver = AuctionSolver(loc=loc, val=vv, shape=(n, n), mode="hybrid",
                               cardinality_check=False, **kw)
        solver.solve()                            # warm: transfer + compile
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = solver.solve()
            times.append(time.perf_counter() - t0)
        meta = res["meta"]
        print(json.dumps({
            "variant": name, **kw,
            "steady_s": round(float(np.median(times)), 3),
            "band": [round(min(times), 3), round(max(times), 3)],
            "device_s": round(meta.get("device_time", 0.0), 3),
            "host_gs_s": round(meta.get("host_gs_time", 0.0), 3),
            "host_bids": int(meta["host_bids"]),
            "phases": int(meta["phases"]),
            "obj": meta["obj"],
        }), flush=True)


if __name__ == "__main__":
    main()
