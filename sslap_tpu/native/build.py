"""Compile-on-demand ctypes loader for the native C++ components.

No pybind11 in this environment (see repo docs), so the native library uses
a plain C ABI over numpy buffers.  The shared object is compiled once per
(source, compiler flags, host CPU) into a cache directory and memoized:
``-march=native`` code built on one CPU may not run on another, so a
build directory copied to a different machine is never reused there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).with_name("sslap_native.cpp")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_dir() -> Path:
    base = os.environ.get("SSLAP_TPU_CACHE")
    if base:
        return Path(base)
    here = Path(__file__).parent
    if os.access(here, os.W_OK):
        return here / "_build"
    return Path(tempfile.gettempdir()) / "sslap_tpu_native"


def host_cpu_tag() -> str:
    """Identity of this host's CPU for the build cache key: architecture,
    model name and instruction-set flags (what ``-march=native`` keys
    on)."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features"):
                    parts.append(line.strip())
                elif not line.strip() and len(parts) > 1:
                    break                   # first processor block only
    except OSError:
        parts.append(platform.processor())
    return "\n".join(parts)


def so_name(src: bytes, flags=_FLAGS, host: Optional[str] = None) -> str:
    """Cache file name of the shared object built from ``src`` with
    ``flags`` on ``host`` (default: this machine)."""
    h = hashlib.sha256(src)
    h.update("\0".join(flags).encode())
    h.update((host_cpu_tag() if host is None else host).encode())
    return f"sslap_native_{h.hexdigest()[:16]}.so"


def load_native() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native library; None on failure."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("SSLAP_TPU_NO_NATIVE"):
        return None
    try:
        cache = _cache_dir()
        cache.mkdir(parents=True, exist_ok=True)
        so = cache / so_name(_SRC.read_bytes())
        if not so.exists():
            tmp = so.with_suffix(f".tmp{os.getpid()}.so")
            cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        _LIB = ctypes.CDLL(str(so))
        _declare(_LIB)
    except Exception:
        _LIB = None
    return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    b8p = ctypes.POINTER(ctypes.c_bool)
    lib.sslap_hopcroft_karp.restype = ctypes.c_int64
    lib.sslap_hopcroft_karp.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p]
    lib.sslap_hopcroft_karp_warm.restype = ctypes.c_int64
    lib.sslap_hopcroft_karp_warm.argtypes = lib.sslap_hopcroft_karp.argtypes
    lib.sslap_hopcroft_karp_i32.restype = ctypes.c_int64
    lib.sslap_hopcroft_karp_i32.argtypes = [
        i64p, i32p, ctypes.c_int64, ctypes.c_int64, i32p, i32p]
    lib.sslap_hopcroft_karp_warm_i32.restype = ctypes.c_int64
    lib.sslap_hopcroft_karp_warm_i32.argtypes = \
        lib.sslap_hopcroft_karp_i32.argtypes
    lib.sslap_rowpack_fill_f32.restype = None
    lib.sslap_rowpack_fill_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, f32p, b8p, i32p,
        ctypes.c_float, ctypes.c_float, i32p]
    lib.sslap_rowpack_fill_i32.restype = None
    lib.sslap_rowpack_fill_i32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p, b8p, i32p,
        ctypes.c_int32, ctypes.c_int32, i32p]
    lib.sslap_wide_count.restype = None
    lib.sslap_wide_count.argtypes = [
        ctypes.c_int64, i32p, b8p, ctypes.c_int32, ctypes.c_int64, i64p]
    lib.sslap_wide_fill_f32.restype = None
    lib.sslap_wide_fill_f32.argtypes = [
        ctypes.c_int64, i32p, f32p, b8p, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p,
        i32p]
    lib.sslap_wide_fill_i32.restype = None
    lib.sslap_wide_fill_i32.argtypes = [
        ctypes.c_int64, i32p, i32p, b8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p,
        i32p]
    lib.sslap_ell_to_csr_f32.restype = None
    lib.sslap_ell_to_csr_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, f32p, b8p,
        ctypes.c_float, i64p, i32p, f32p]
    lib.sslap_ell_to_csr_f64.restype = None
    lib.sslap_ell_to_csr_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, f64p, b8p,
        ctypes.c_double, i64p, i32p, f64p]
    lib.sslap_ell_to_csr_i32.restype = None
    lib.sslap_ell_to_csr_i32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p, b8p,
        ctypes.c_int32, i64p, i32p, i32p]
    lib.sslap_eps_cs_stats_f32.restype = None
    lib.sslap_eps_cs_stats_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, f32p, b8p, f32p, i32p,
        ctypes.c_float, f32p, f32p, f32p, f32p]
    lib.sslap_coo_prepare.restype = ctypes.c_int64
    lib.sslap_coo_prepare.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p, i64p]
    lib.sslap_ell_fill_f32.restype = None
    lib.sslap_ell_fill_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, f32p, i64p, i64p, i32p, f32p, b8p]
    lib.sslap_ell_fill_f64.restype = None
    lib.sslap_ell_fill_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, f64p, i64p, i64p, i32p, f64p, b8p]
    lib.sslap_ell_fill_i32.restype = None
    lib.sslap_ell_fill_i32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i32p, i64p, i64p, i32p, i32p, b8p]
    lib.sslap_auction_gs_f32.restype = ctypes.c_int64
    lib.sslap_auction_gs_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p,
        f32p, i32p, i32p, ctypes.c_float, ctypes.c_float,
        ctypes.c_int64, ctypes.c_int64]
    lib.sslap_auction_gs_i32.restype = ctypes.c_int64
    lib.sslap_auction_gs_i32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p,
        i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64]
    lib.sslap_auction_gs_f64.restype = ctypes.c_int64
    lib.sslap_auction_gs_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p,
        f64p, i32p, i32p, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64]
    lib.sslap_unassign_violators_f64.restype = None
    lib.sslap_unassign_violators_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p,
        f64p, i32p, i32p, ctypes.c_double, ctypes.c_int64]
    lib.sslap_auction_gs_pf_f32.restype = ctypes.c_int64
    lib.sslap_auction_gs_pf_f32.argtypes = lib.sslap_auction_gs_f32.argtypes
    lib.sslap_auction_gs_pf_i32.restype = ctypes.c_int64
    lib.sslap_auction_gs_pf_i32.argtypes = lib.sslap_auction_gs_i32.argtypes
    lib.sslap_unassign_violators_f32.restype = None
    lib.sslap_unassign_violators_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p,
        f32p, i32p, i32p, ctypes.c_float, ctypes.c_int64]
    lib.sslap_unassign_violators_i32.restype = None
    lib.sslap_unassign_violators_i32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p,
        i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int64]
    for nm, fp, ct in (("sslap_auction_gs_fr_f32", f32p, ctypes.c_float),
                       ("sslap_auction_gs_fr_f64", f64p, ctypes.c_double),
                       ("sslap_auction_gs_fr_i32", i32p, ctypes.c_int32)):
        fn = getattr(lib, nm)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p, fp,
                       i64p, i32p, fp, fp, fp, i32p, i32p, ct, ct,
                       ctypes.c_int64]
    lib.sslap_fr_tighten_f32.restype = None
    lib.sslap_fr_tighten_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p, f32p,
        ctypes.c_int64]
    lib.sslap_fr_tighten_f64.restype = None
    lib.sslap_fr_tighten_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p, f64p,
        ctypes.c_int64]
    lib.sslap_fr_tighten_i32.restype = None
    lib.sslap_fr_tighten_i32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p, i32p,
        ctypes.c_int64]


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def hopcroft_karp_native(indptr: np.ndarray, indices: np.ndarray,
                         n: int, m: int) -> Tuple[np.ndarray, np.ndarray, int]:
    lib = load_native()
    assert lib is not None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    match_row = np.empty(n, np.int64)
    match_col = np.empty(m, np.int64)
    size = lib.sslap_hopcroft_karp(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
        n, m, _ptr(match_row, ctypes.c_int64), _ptr(match_col, ctypes.c_int64))
    return match_row, match_col, int(size)


def hopcroft_karp_warm_native(indptr: np.ndarray, indices: np.ndarray,
                              n: int, m: int,
                              match_row: np.ndarray, match_col: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """HK augmentation from a caller-provided initial matching (modified
    in place; must be a consistent partial matching)."""
    lib = load_native()
    assert lib is not None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    assert match_row.dtype == np.int64 and match_row.flags.c_contiguous
    assert match_col.dtype == np.int64 and match_col.flags.c_contiguous
    size = lib.sslap_hopcroft_karp_warm(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
        n, m, _ptr(match_row, ctypes.c_int64), _ptr(match_col, ctypes.c_int64))
    return match_row, match_col, int(size)


def hopcroft_karp_native_i32(indptr: np.ndarray, indices: np.ndarray,
                             n: int, m: int,
                             init_match: Optional[Tuple[np.ndarray,
                                                        np.ndarray]] = None
                             ) -> Tuple[np.ndarray, np.ndarray, int]:
    """int32-index Hopcroft-Karp (n, m < 2^31): halves the CSR + match
    memory traffic vs the int64 ABI -- the BFS/DFS sweeps are bandwidth
    bound at capacity scale (10M rows / 100M nnz)."""
    lib = load_native()
    assert lib is not None
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    if init_match is None:
        match_row = np.empty(n, np.int32)
        match_col = np.empty(m, np.int32)
        size = lib.sslap_hopcroft_karp_i32(
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
            n, m, _ptr(match_row, ctypes.c_int32),
            _ptr(match_col, ctypes.c_int32))
    else:
        match_row = np.ascontiguousarray(init_match[0], np.int32).copy()
        match_col = np.ascontiguousarray(init_match[1], np.int32).copy()
        size = lib.sslap_hopcroft_karp_warm_i32(
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
            n, m, _ptr(match_row, ctypes.c_int32),
            _ptr(match_col, ctypes.c_int32))
    return match_row, match_col, int(size)


def ell_to_csr_native(cols: np.ndarray, vals: np.ndarray,
                      valid: np.ndarray, sign_scale, nnz: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]]:
    """Fused native ELL -> CSR of transformed values: one pass over
    cols/vals/valid writing (indptr int64, indices int32, data vals.dtype)
    directly.  Replaces numpy boolean fancy-indexing, which runs
    np.nonzero per indexing op and materializes [nnz] int64 index temps
    (~0.8 GB each at 100M nnz; 49.5 s at the 10M scale config, PERF.md).
    Returns None when the native library / dtype is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    n, K = cols.shape
    dtype = vals.dtype
    if dtype == np.float32:
        fn, ct = lib.sslap_ell_to_csr_f32, ctypes.c_float
    elif dtype == np.float64:
        fn, ct = lib.sslap_ell_to_csr_f64, ctypes.c_double
    elif dtype == np.int32:
        fn, ct = lib.sslap_ell_to_csr_i32, ctypes.c_int32
    else:
        return None
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, dtype)
    valid = np.ascontiguousarray(valid, bool)
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(nnz, np.int32)
    data = np.empty(nnz, dtype)
    fn(n, K, _ptr(cols, ctypes.c_int32), _ptr(vals, ct),
       _ptr(valid, ctypes.c_bool), ct(sign_scale),
       _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
       _ptr(data, ct))
    return indptr, indices, data


def eps_cs_stats(cols: np.ndarray, vals: np.ndarray, valid: np.ndarray,
                 prices: np.ndarray, sigma: np.ndarray, sign_scale
                 ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                     np.ndarray, float]]:
    """Fused eps-CS certificate statistics over the f32 ELL image: per-row
    (v1, cur, a_orig) + global max |w|, one read of each input and no
    [n, K] temps (the numpy formulation allocates ~3 GB of them at
    10M x 16 and measured 158 s, PERF.md round-3 table).  Violation
    counting and the objective sum stay with the caller so the f32
    summation semantics match the numpy path exactly.  Returns None when
    the native library is unavailable or vals is not float32."""
    lib = load_native()
    if lib is None or vals.dtype != np.float32:
        return None
    n, K = cols.shape
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    valid = np.ascontiguousarray(valid, bool)
    prices = np.ascontiguousarray(prices, np.float32)
    sigma = np.ascontiguousarray(sigma, np.int32)
    v1 = np.empty(n, np.float32)
    cur = np.empty(n, np.float32)
    a_orig = np.empty(n, np.float32)
    wmax = np.zeros(1, np.float32)
    lib.sslap_eps_cs_stats_f32(
        n, K, _ptr(cols, ctypes.c_int32), _ptr(vals, ctypes.c_float),
        _ptr(valid, ctypes.c_bool), _ptr(prices, ctypes.c_float),
        _ptr(sigma, ctypes.c_int32), ctypes.c_float(sign_scale),
        _ptr(v1, ctypes.c_float), _ptr(cur, ctypes.c_float),
        _ptr(a_orig, ctypes.c_float), _ptr(wmax, ctypes.c_float))
    return v1, cur, a_orig, float(wmax[0])


def rowpack_fill(cols: np.ndarray, vals: np.ndarray, valid: np.ndarray,
                 nvalid: np.ndarray, sign_scale, neg, npad: int
                 ) -> Optional[np.ndarray]:
    """Fused native ELL -> RowPack image: returns the packed [npad, 2K+1]
    int32 array (transform + sentinel masking applied in the same pass),
    or None when the native library / dtype is unavailable.  ``npad`` >= n
    zero-fills the padding rows (nvalid = 0: inert)."""
    lib = load_native()
    if lib is None:
        return None
    n, K = cols.shape
    dtype = vals.dtype
    if dtype == np.float32:
        fn, ct = lib.sslap_rowpack_fill_f32, ctypes.c_float
    elif dtype == np.int32:
        fn, ct = lib.sslap_rowpack_fill_i32, ctypes.c_int32
    else:
        return None
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, dtype)
    valid = np.ascontiguousarray(valid, bool)
    nvalid = np.ascontiguousarray(nvalid, np.int32)
    out = np.zeros((npad, 2 * K + 1), np.int32)
    fn(n, K, _ptr(cols, ctypes.c_int32), _ptr(vals, ct),
       _ptr(valid, ctypes.c_bool), _ptr(nvalid, ctypes.c_int32),
       ct(sign_scale), ct(neg), _ptr(out, ctypes.c_int32))
    return out


def wide_fill(cols: np.ndarray, vals: np.ndarray, valid: np.ndarray,
              m: int, sign_scale, neg, E_force: int = 0):
    """Fused native wide-layout build (ops/widebid.py): counting-sort
    placement of ELL entries into column-window groups, transform +
    sentinel masking in the same pass.  Returns (coff [NB, E],
    vals_cg [NB, E], dest [NB*E]) or None when native/dtype unavailable.
    Bit-identical to the numpy stable-argsort path."""
    lib = load_native()
    if lib is None:
        return None
    dtype = vals.dtype
    if dtype == np.float32:
        fn, ct = lib.sslap_wide_fill_f32, ctypes.c_float
    elif dtype == np.int32:
        fn, ct = lib.sslap_wide_fill_i32, ctypes.c_int32
    else:
        return None
    n, K = cols.shape
    nK = n * K
    NB = -(-m // 128)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, dtype)
    valid = np.ascontiguousarray(valid, bool)
    counts = np.zeros(NB, np.int64)
    lib.sslap_wide_count(nK, _ptr(cols, ctypes.c_int32),
                         _ptr(valid, ctypes.c_bool), ctypes.c_int32(m),
                         ctypes.c_int64(NB), _ptr(counts, ctypes.c_int64))
    E = max(int(counts.max()), 1) if nK else 1
    if E_force:
        if E > E_force:
            raise ValueError(f"E_force {E_force} < required {E}")
        E = E_force
    # Skew guard: a column-window holding a large share of the entries
    # (adversarial or degenerate instances) blows the [NB, E] padding up
    # to NB*E >> nK; the layout (and the wide rounds) stop paying for
    # themselves long before the memory does.  Callers fall back to the
    # scalar-gather rounds on None.
    if NB * E > 3 * nK + NB * 128:
        return "skewed"
    cursor = np.zeros(NB, np.int64)
    coff = np.zeros((NB, E), np.int32)
    vals_cg = np.zeros((NB, E), dtype)
    dest = np.empty(NB * E, np.int32)
    fn(nK, _ptr(cols, ctypes.c_int32), _ptr(vals, ct),
       _ptr(valid, ctypes.c_bool), ct(sign_scale), ct(neg),
       ctypes.c_int32(m), ctypes.c_int64(NB), ctypes.c_int64(E),
       _ptr(cursor, ctypes.c_int64), _ptr(coff, ctypes.c_int32),
       _ptr(vals_cg, ct), _ptr(dest, ctypes.c_int32))
    return coff, vals_cg, dest


def auction_gs(indptr: np.ndarray, indices: np.ndarray, vals: np.ndarray,
               prices: np.ndarray, sigma: np.ndarray, owner: np.ndarray,
               eps, bigp, n_dummy_total: int, max_bids: int,
               prefetch: bool = False) -> int:
    """Run the native Gauss-Seidel auction in place over CSR (transformed
    maximization values).  ``prices``/``sigma``/``owner`` are modified.
    Returns bids performed, or -1 if max_bids was exhausted.

    ``prefetch`` selects a software-prefetching variant of the scan; on
    the 1-vCPU development VM it measured SLOWER (the out-of-order core
    already overlaps the independent price loads), so the plain loop is
    the default.  The variant is kept for wider-core hosts."""
    lib = load_native()
    assert lib is not None, "native library unavailable"
    n = sigma.shape[0]
    m = prices.shape[0]
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    assert sigma.dtype == np.int32 and owner.dtype == np.int32
    assert sigma.flags.c_contiguous and owner.flags.c_contiguous
    assert prices.flags.c_contiguous and vals.flags.c_contiguous
    if prices.dtype == np.float32:
        fn = lib.sslap_auction_gs_pf_f32 if prefetch else             lib.sslap_auction_gs_f32
        ct = ctypes.c_float
        assert vals.dtype == np.float32
    elif prices.dtype == np.float64:
        fn, ct = lib.sslap_auction_gs_f64, ctypes.c_double
        assert vals.dtype == np.float64
    elif prices.dtype == np.int32:
        fn = lib.sslap_auction_gs_pf_i32 if prefetch else             lib.sslap_auction_gs_i32
        ct = ctypes.c_int32
        assert vals.dtype == np.int32
    else:
        raise TypeError(f"unsupported dtype {prices.dtype}")
    return int(fn(
        n, m, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(vals, ct), _ptr(prices, ct), _ptr(sigma, ctypes.c_int32),
        _ptr(owner, ctypes.c_int32), ct(eps), ct(bigp),
        int(n_dummy_total), int(max_bids)))


def unassign_violators_native(indptr: np.ndarray, indices: np.ndarray,
                              vals: np.ndarray, prices: np.ndarray,
                              sigma: np.ndarray, owner: np.ndarray,
                              eps, n_dummy_total: int) -> None:
    """In-place warm-started eps-scaling step: free only eps-CS violators
    (host mirror of auction.py:unassign_violators)."""
    lib = load_native()
    assert lib is not None, "native library unavailable"
    n = sigma.shape[0]
    m = prices.shape[0]
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    if prices.dtype == np.float32:
        fn, ct = lib.sslap_unassign_violators_f32, ctypes.c_float
    elif prices.dtype == np.float64:
        fn, ct = lib.sslap_unassign_violators_f64, ctypes.c_double
    elif prices.dtype == np.int32:
        fn, ct = lib.sslap_unassign_violators_i32, ctypes.c_int32
    else:
        raise TypeError(f"unsupported dtype {prices.dtype}")
    fn(n, m, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
       _ptr(vals, ct), _ptr(prices, ct), _ptr(sigma, ctypes.c_int32),
       _ptr(owner, ctypes.c_int32), ct(eps), int(n_dummy_total))


def auction_gs_fr(indptr: np.ndarray, indices: np.ndarray,
                  vals: np.ndarray, cindptr: np.ndarray,
                  cindices: np.ndarray, cvals: np.ndarray,
                  prices: np.ndarray, profits: np.ndarray,
                  sigma: np.ndarray, owner: np.ndarray,
                  eps, bigp, max_bids: int) -> int:
    """Run the native combined forward-reverse Gauss-Seidel auction in
    place over CSR + CSC (square problems; transformed maximization
    values).  ``prices``/``profits``/``sigma``/``owner`` are modified.
    Returns bids performed, or -1 if max_bids was exhausted."""
    lib = load_native()
    assert lib is not None, "native library unavailable"
    n = sigma.shape[0]
    m = prices.shape[0]
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    cindptr = np.ascontiguousarray(cindptr, np.int64)
    cindices = np.ascontiguousarray(cindices, np.int32)
    assert sigma.dtype == np.int32 and owner.dtype == np.int32
    assert prices.dtype == vals.dtype == cvals.dtype == profits.dtype
    for a in (prices, profits, sigma, owner, vals, cvals):
        assert a.flags.c_contiguous
    if prices.dtype == np.float32:
        fn, ct = lib.sslap_auction_gs_fr_f32, ctypes.c_float
    elif prices.dtype == np.float64:
        fn, ct = lib.sslap_auction_gs_fr_f64, ctypes.c_double
    elif prices.dtype == np.int32:
        fn, ct = lib.sslap_auction_gs_fr_i32, ctypes.c_int32
    else:
        raise TypeError(f"unsupported dtype {prices.dtype}")
    return fn(n, m, _ptr(indptr, ctypes.c_int64),
              _ptr(indices, ctypes.c_int32), _ptr(vals, ct),
              _ptr(cindptr, ctypes.c_int64), _ptr(cindices, ctypes.c_int32),
              _ptr(cvals, ct), _ptr(prices, ct), _ptr(profits, ct),
              _ptr(sigma, ctypes.c_int32), _ptr(owner, ctypes.c_int32),
              ct(eps), ct(bigp), int(max_bids))


def fr_tighten_native(indptr: np.ndarray, indices: np.ndarray,
                      vals: np.ndarray, prices: np.ndarray,
                      iters: int = 1) -> bool:
    """In-place forward-reverse dual tightening over CSR (transformed
    maximization values; see fr_tighten in sslap_native.cpp).  Prices can
    only fall.  Returns False when the native library is unavailable (the
    caller falls back to the numpy sweep in auction.fr_tighten)."""
    lib = load_native()
    if lib is None:
        return False
    n = indptr.shape[0] - 1
    m = prices.shape[0]
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    assert prices.flags.c_contiguous and vals.flags.c_contiguous
    assert prices.dtype == vals.dtype
    if prices.dtype == np.float32:
        fn, ct = lib.sslap_fr_tighten_f32, ctypes.c_float
    elif prices.dtype == np.float64:
        fn, ct = lib.sslap_fr_tighten_f64, ctypes.c_double
    elif prices.dtype == np.int32:
        fn, ct = lib.sslap_fr_tighten_i32, ctypes.c_int32
    else:
        return False
    fn(n, m, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
       _ptr(vals, ct), _ptr(prices, ct), int(iters))
    return True


def build_ell_native(rr: np.ndarray, cc: np.ndarray, vv: np.ndarray,
                     n: int, m: int, dtype: np.dtype,
                     pad_to: Optional[int] = None):
    """COO -> (cols[n,K] i32, vals[n,K], valid[n,K] bool, counts[n] i64, K).
    Returns None if the native library or dtype path is unavailable; raises
    ValueError on duplicates / out-of-range (mirroring ingest.py)."""
    lib = load_native()
    if lib is None:
        return None
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        fill, ct = lib.sslap_ell_fill_f32, ctypes.c_float
    elif dtype == np.float64:
        fill, ct = lib.sslap_ell_fill_f64, ctypes.c_double
    elif dtype == np.int32:
        fill, ct = lib.sslap_ell_fill_i32, ctypes.c_int32
    else:
        return None
    nnz = int(rr.shape[0])
    rr = np.ascontiguousarray(rr, np.int64)
    cc = np.ascontiguousarray(cc, np.int64)
    vv = np.ascontiguousarray(vv, dtype)
    perm = np.empty(nnz, np.int64)
    counts = np.empty(n, np.int64)
    K = lib.sslap_coo_prepare(
        nnz, n, m, _ptr(rr, ctypes.c_int64), _ptr(cc, ctypes.c_int64),
        _ptr(perm, ctypes.c_int64), _ptr(counts, ctypes.c_int64))
    if K == -1:
        raise ValueError("duplicate (row, col) entries in sparse input")
    if K == -2:
        raise ValueError("loc indices out of bounds for given shape")
    K = max(int(K), int(pad_to or 1), 1)
    ell_cols = np.empty((n, K), np.int32)
    ell_vals = np.empty((n, K), dtype)
    ell_valid = np.empty((n, K), bool)
    fill(nnz, n, K,
         _ptr(rr, ctypes.c_int64), _ptr(cc, ctypes.c_int64), _ptr(vv, ct),
         _ptr(perm, ctypes.c_int64), _ptr(counts, ctypes.c_int64),
         _ptr(ell_cols, ctypes.c_int32), _ptr(ell_vals, ct),
         _ptr(ell_valid, ctypes.c_bool))
    return ell_cols, ell_vals, ell_valid, counts, K
