"""Device round formulations beyond the plain jnp rounds in auction.py.

widebid.py -- window-gather full-width bid round: column-window-grouped
              price select + static sorted join, bit-identical to the
              scalar gather ``vals_t - prices[cols]``.
"""

from sslap_tpu.ops.widebid import WideLayout, build_wide_layout, wide_w

__all__ = ["WideLayout", "build_wide_layout", "wide_w"]
