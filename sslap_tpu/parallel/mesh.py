"""Mesh construction helpers (T8).

One host: a 1-D 'rows' axis over all local devices in device order.  The
four H100s of one host are joined all to all by NVLink, so every card
reaches every other at the same rate and the axis order does not matter.
Multi-host: the axis is ordered process-major, so each host's cards stay
adjacent and the larger part of every price combine stays on NVLink.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize wrapper for multi-host pods.  No-op when
    already initialized or single-process (SURVEY.md SS6 T8).

    Deliberately does NOT call jax.process_count() to detect prior
    initialization: that call BOOTS the local backend, after which
    distributed initialization is impossible -- the original no-op guard
    here silently broke every later collective (found by the two-process
    Gloo simulation, benchmarks/multiproc_sim.py)."""
    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None:
        if is_init():
            return
    else:  # older jax: same check via the private state, without booting
        from jax._src import distributed as _dist
        if getattr(_dist.global_state, "client", None) is not None:
            return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        # Auto-detection on a single-process launch legitimately fails;
        # an EXPLICIT multi-process request must not fail silently.
        if explicit:
            raise


def put_global(x, mesh: Mesh, spec: PartitionSpec):
    """Place a host array that is IDENTICAL on every process onto ``mesh``
    with an explicit sharding.

    Single-process: returns ``x`` unchanged -- jit's default commit path
    handles placement and an eager device_put would only add a transfer.
    Multi-process: jit cannot auto-commit a host array onto a mesh that
    spans processes, so each process device_puts the full (identical)
    global array and jax slices out this process's addressable shards.
    """
    if jax.process_count() == 1:
        return x
    return jax.device_put(x, NamedSharding(mesh, spec))


def put_global_args(mesh: Mesh, specs, args):
    """``put_global`` over an argument tuple (one spec per arg).  The ONE
    placement path every distributed backend shares: single-process
    returns ``args`` unchanged; multi-process converts each to host numpy
    first (eager jnp operands are process-local buffers)."""
    if jax.process_count() == 1:
        return tuple(args)
    return tuple(put_global(np.asarray(a), mesh, s)
                 for a, s in zip(args, specs, strict=True))


def fetch_global(x) -> np.ndarray:
    """Full host numpy value of a global jax.Array.

    Single-process, replicated, or fully-addressable arrays convert
    directly (an allgather of a fully-addressable array would concatenate
    every process's full copy -- nproc x too large).  Only an array that
    actually SPANS processes goes through
    ``multihost_utils.process_allgather`` -- a COLLECTIVE: every process
    must call this on the same arrays in the same order (the SPMD rule
    all of parallel/ already follows).
    """
    if (jax.process_count() == 1
            or getattr(x, "is_fully_replicated", True)
            or getattr(x, "is_fully_addressable", False)):
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = "rows") -> Mesh:
    """1-D mesh over all (or given) devices.  For multi-host runs, uses the
    hybrid mesh helper so the axis ordering keeps each host's devices
    adjacent (collectives ride NVLink first, the network last)."""
    if devices is not None:
        return Mesh(np.asarray(devices), (axis_name,))
    n_local = len(jax.local_devices())
    n_total = len(jax.devices())
    if jax.process_count() > 1 and n_total > n_local:
        try:
            dev = mesh_utils.create_hybrid_device_mesh(
                mesh_shape=(n_local,),
                dcn_mesh_shape=(jax.process_count(),),
            )
            return Mesh(dev.reshape(-1), (axis_name,))
        except ValueError:
            # Backends whose devices carry no slice_index (e.g. the
            # multi-process CPU simulation): jax.devices() is already
            # process-major, which keeps intra-process neighbors adjacent
            # on the 1-D axis -- the same host-major ordering the hybrid
            # helper produces.
            pass
    return Mesh(np.asarray(jax.devices()), (axis_name,))
