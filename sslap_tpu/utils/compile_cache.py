"""Persistent XLA compilation cache location.

The 1M-row hybrid program takes a long time to compile; a persistent
cache lets later processes on the same machine start in seconds.  The
cache directory is part of the cache key, so it must not move between
runs.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this sets nothing.  Otherwise the cache goes to ``.jax_cache`` at the
    root of the checkout (listed in ``.gitignore``)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    path = str(_CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
