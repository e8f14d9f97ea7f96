"""Tracking workload: frame-to-frame assignment with warm-started prices.

The reference's headline use-case is multi-object tracking: every frame,
match N tracks to N detections by (sparse) association cost.  Costs change
only slightly between frames, so the previous frame's price vector is a
near-optimal dual warm start -- the auction re-converges in a fraction of
the cold rounds (a capability the reference does not expose; SURVEY.md SS6
'Checkpoint / resume').

Run:  python examples/tracking.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sslap_tpu import AuctionSolver  # noqa: E402
from sslap_tpu.utils import load_state, save_state  # noqa: E402


def frame_costs(rng, n, base_pos, jitter=0.02, cand=8):
    """Sparse association costs: each track considers its ``cand`` nearest
    detections by (noisy) position distance."""
    det_pos = base_pos + rng.normal(0, jitter, base_pos.shape)
    order = np.argsort(
        np.abs(base_pos[:, None] - det_pos[None, :]), axis=1)[:, :cand]
    rows = np.repeat(np.arange(n), cand)
    cols = order.ravel()
    # include each track's true detection so a perfect matching exists
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    val = np.abs(base_pos[rows] - det_pos[cols]).astype(np.float32) * 1e3 + 1
    return np.stack([rows, cols], axis=1), val


def main():
    rng = np.random.default_rng(0)
    n = 2000
    base_pos = np.sort(rng.random(n))

    prices = None
    t0 = time.perf_counter()
    for frame in range(5):
        loc, val = frame_costs(rng, n, base_pos)
        solver = AuctionSolver(loc=loc, val=val, shape=(n, n),
                               mode="device", cardinality_check=False)
        # Warm prices carry the learned duals across frames; the full eps
        # schedule re-anneals the (small) cost changes.  (Do NOT warm-start
        # with a tiny eps_start: correcting cost changes of magnitude D at
        # fixed eps takes ~D/eps rounds per contested column -- the classic
        # auction warm-start pitfall.  On the 'hybrid'/'cpu' engines, add
        # warm_mode="fr" when the pattern churns or frames chain: the
        # forward-reverse tightening lowers stale duals to the new market
        # level first -- see benchmarks/tracking.py and PERF.md round 5.)
        res = solver.solve(warm_prices=prices)
        if frame == 1:
            # Fair comparison on the SAME frame: cold vs warm.
            cold = AuctionSolver(loc=loc, val=val, shape=(n, n),
                                 mode="device",
                                 cardinality_check=False).solve()
            print(f"  frame 1 cold rounds {cold['meta']['its']} vs warm "
                  f"{res['meta']['its']} "
                  f"({cold['meta']['its'] / res['meta']['its']:.1f}x fewer)")
        prices = solver.prices
        kind = "cold" if frame == 0 else "warm"
        print(f"frame {frame} ({kind}): objective {res['meta']['obj']:.1f} "
              f"rounds {res['meta']['its']}")
    print(f"5 frames in {time.perf_counter() - t0:.2f}s")

    # Prices survive process restarts through the checkpoint utils.
    path = "/tmp/tracking_prices.npz"
    save_state(path, prices, eps=1e-2, extra={"frame": 4})
    restored, meta = load_state(path)
    print("checkpoint round-trip OK:", np.array_equal(restored, prices),
          "| meta:", meta["extra"])

    # Feasibility checks warm-start the same way: seed Hopcroft-Karp with
    # the previous frame's matching (stale edges are sanitized away).
    # Measured at 10M rows: 2.6 s warm vs 64 s cold (PERF.md round 3).
    from sslap_tpu import hopcroft_solve
    loc, val = frame_costs(rng, n, base_pos)
    cold_match = hopcroft_solve(loc=loc, shape=(n, n))
    loc2, _ = frame_costs(rng, n, base_pos)
    warm_match = hopcroft_solve(loc=loc2, shape=(n, n), warm=cold_match)
    print("warm HK matching size:", int((warm_match >= 0).sum()), "/", n)


if __name__ == "__main__":
    main()
