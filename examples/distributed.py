"""Distributed solves: row-sharding one LAP over a device mesh.

Three backends (SURVEY.md SS3b T7/T8), all drop-in `auction_solve`
replacements:

  auction_solve_sharded         full-width Jacobi rounds, 2x[m] combines;
                                bit-identical to the unsharded solve.
  auction_solve_overlapped      depth-1 comm/compute pipelined combines.
  auction_solve_sharded_hybrid  the config-5 performance path: per-shard
                                RowPack tiered compaction, compact
                                active-set exchanges (collective bytes
                                track the ACTIVE SET, not m), truncated
                                phases, host GS tail; `overlap=True`
                                additionally pipelines the wide rounds.

No multi-chip hardware?  Neither has this environment: the example forces
an 8-virtual-device CPU mesh, the same trick the test suite uses.  On a
real slice, drop the platform override and `make_mesh()` picks up all
local devices (multi-host: `initialize_multihost()` first).

Multi-HOST launch pattern: run the identical script once per host (SPMD),
calling `initialize_multihost(coordinator, num_processes, process_id)`
before the first device query; every solver below then works unchanged --
input placement and result gathering across processes happen inside
(`parallel.mesh.put_global` / `fetch_global`).  A runnable two-process
demonstration (real cross-client Gloo collectives on one box) is
`python benchmarks/multiproc_sim.py`.

Run:  python examples/distributed.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not os.environ.get("SSLAP_TPU_EXAMPLE_REAL_MESH"):
    # 8 virtual CPU devices (must happen before the first device query).
    jax.config.update("jax_platforms", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

from sslap_tpu import auction_solve  # noqa: E402
from sslap_tpu.parallel import (  # noqa: E402
    auction_solve_sharded,
    auction_solve_sharded_hybrid,
    make_mesh,
)


def main():
    rng = np.random.default_rng(7)
    n = 2048
    # sparse instance with a planted perfect matching
    ii = np.repeat(np.arange(n), 8)
    jj = (ii + rng.integers(0, n, ii.size)) % n
    perm = rng.permutation(n)
    loc = np.stack([np.concatenate([ii, np.arange(n)]),
                    np.concatenate([jj, perm])], 1)
    loc = np.unique(loc, axis=0)
    val = rng.integers(1, 1000, len(loc)).astype(np.int32)

    mesh = make_mesh()                     # 1-D 'rows' mesh over all devices
    print(f"mesh: {mesh.shape} over {jax.devices()[0].platform}")

    single = auction_solve(loc=loc, val=val, shape=(n, n), mode="device",
                           cardinality_check=False)

    # Full-width sharded round: bit-identical to the single-device solve.
    sh = auction_solve_sharded(loc=loc, val=val, shape=(n, n), mesh=mesh,
                               cardinality_check=False)
    assert (sh["sol"] == single["sol"]).all()
    print(f"sharded     obj {sh['meta']['obj']} "
          f"(assignment identical to single-device) "
          f"rounds {sh['meta']['its']}")

    # Sharded hybrid: the scale path.  trunc=0 keeps exact single-device
    # parity; the default trunc hands the serial eviction-chain tail to
    # one host's native Gauss-Seidel pass.
    # trunc=64: run the device ladder down to 64 active rows before the
    # host tail, so the compact-exchange tiers actually engage here.
    hy = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, n),
                                      mesh=mesh, trunc=64,
                                      cardinality_check=False)
    m = hy["meta"]
    print(f"sharded hyb obj {m['obj']} rounds {m['its']} "
          f"host-tail bids {m['host_bids']}")
    print(f"  collective bytes: {m['comm_bytes_total']/1e6:.1f} MB vs "
          f"{m['comm_bytes_fullwidth_equiv']/1e6:.1f} MB full-width-equiv "
          f"({m['comm_bytes_fullwidth_equiv']/max(m['comm_bytes_total'],1):.1f}x "
          "less on the wire; the ratio grows with scale -- 30x at "
          "1M x 1M, PERF.md round 3)")

    # Overlapped variant: wide rounds pipelined one deep (pays off when
    # the [m] all-reduce is comparable to the bid compute -- real
    # ICI/DCN meshes, not this CPU sim).
    ov = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, n),
                                      mesh=mesh, trunc=64, overlap=True,
                                      cardinality_check=False)
    assert ov["meta"]["obj"] == hy["meta"]["obj"]
    print(f"overlap=True obj matches; rounds {ov['meta']['its']} "
          f"(vs {m['its']} sync: the pipeline's round-count price)")

    # Mesh-balanced ladder buffers: narrow-tier compute shrinks with the
    # mesh (~2C/D buffers + local spill rebuilds) -- the multi-card
    # scaling knob.  Opt-in: costs trunc=0 bit-exactness, never
    # objective optimality.
    bal = auction_solve_sharded_hybrid(loc=loc, val=val, shape=(n, n),
                                       mesh=mesh, trunc=64,
                                       ladder_balance=True,
                                       cardinality_check=False)
    assert bal["meta"]["obj"] == hy["meta"]["obj"]
    print(f"ladder_balance=True obj matches; "
          f"spill rebuilds {bal['meta']['ladder_rebuilds']}, "
          f"collective bytes {bal['meta']['comm_bytes_total']/1e6:.1f} MB")


if __name__ == "__main__":
    main()
