"""Auxiliary subsystems (SURVEY.md SS6): checkpoint/warm-start, profiling,
observability, compile-cache location.  The reference has none of these
beyond a wall-clock field in its meta dict; they are first-class here
because solver state is a tiny pytree and device solves are long."""

from sslap_tpu.utils.checkpoint import load_state, save_state
from sslap_tpu.utils.compile_cache import enable_compile_cache
from sslap_tpu.utils.profiling import profile_trace, trace_annotation

__all__ = ["save_state", "load_state", "profile_trace", "trace_annotation",
           "enable_compile_cache"]
