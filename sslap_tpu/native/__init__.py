"""Native (C++) host-side runtime components.

The reference's native tier is Cython for the hot solve loop; here the
device hot loop lives in XLA, so the native tier covers *host-side*
work the way the reference's Cython covers ingest/feasibility: COO->ELL
building and Hopcroft-Karp over CSR.  Compiled on demand with g++ via
ctypes (no pybind11 in this environment); every consumer falls back to the
pure numpy implementations when the toolchain is unavailable.
"""

from sslap_tpu.native.build import load_native

_lib = load_native()

if _lib is not None:
    from sslap_tpu.native.build import (
        auction_gs,
        build_ell_native,
        ell_to_csr_native,
        eps_cs_stats,
        hopcroft_karp_native,
        hopcroft_karp_native_i32,
        hopcroft_karp_warm_native,
        rowpack_fill,
        wide_fill,
        unassign_violators_native,
    )
else:  # toolchain unavailable: numpy fallbacks are used by callers
    hopcroft_karp_native = None
    hopcroft_karp_native_i32 = None
    hopcroft_karp_warm_native = None
    build_ell_native = None
    ell_to_csr_native = None
    eps_cs_stats = None
    auction_gs = None
    unassign_violators_native = None
    rowpack_fill = None
    wide_fill = None
