"""Test harness config.

All tests run on CPU with 8 virtual devices so that shard_map / mesh logic
is exercised without multi-card hardware (SURVEY.md SS5.2: the solver is
platform-agnostic; chip_smoke.py and bench.py run on the GPU).  Tests
marked ``gpu`` reach the card from a child process.

The platform is also pinned through jax.config, in case jax was imported
before this file ran.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
