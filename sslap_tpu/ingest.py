"""Ingest: dense / COO sparse cost matrices -> padded ELL device layout.

Device data layer (SURVEY.md SS2b "Data layer", component T1). The
reference (sslap, SURVEY.md SS3a R2 ingest) converts dense matrices with
negative == forbidden entries, or COO ``loc``/``val`` pairs, into per-row
CSR-like arrays inside its Cython solver.  Here we instead build a *padded
ELL* layout -- ``cols[n, K]`` / ``vals[n, K]`` with a validity mask, K = max
nnz per row -- because static shapes are what XLA wants: every bidding
round streams the same rectangular [n, K] block with no data-dependent
shapes.

Note on provenance: the reference mount was empty this session (SURVEY.md
SS0), so behavior is matched against the reconstructed contract in SURVEY.md
SS1/SS4 and validated against scipy oracles in tests/.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax


def _native_builder():
    """Lazy import of the optional C++ COO->ELL builder (native/build.py)."""
    try:
        from sslap_tpu.native import build_ell_native
        return build_ell_native
    except Exception:
        return None


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ELLProblem:
    """A LAP instance in padded-ELL layout.

    Arrays are kept HOST-side (numpy) after ingest: host-side consumers
    (feasibility, CSR conversion, exact objective) would otherwise
    round-trip every array through the device.
    Device solve paths pass the pytree into jit, which performs the single
    host->device transfer.

    Attributes:
      cols:   int32 [n, K]  column index of each stored entry; padding = 0
              (kept in-bounds so gathers never go OOB; ``valid`` masks it).
              Within each row, columns are sorted ascending -- this makes
              ``argmax`` (first-max) tie-breaking equal to "lowest column
              index", the documented deterministic rule.
      vals:   [n, K] raw (untransformed) costs; padding = 0.
      valid:  bool [n, K] True for real entries.
      nvalid: int32 [n] number of valid entries per row.
      n, m:   problem shape (rows <= cols required by the solver).
      int_exact: values are integers stored in float64 (costs too large for
              the int32 path); solved exactly via (m+1) scaling in f64
              (exact while |cost| * (m+1) < 2**50).
    """

    cols: jax.Array
    vals: jax.Array
    valid: jax.Array
    nvalid: jax.Array
    n: int
    m: int
    int_exact: bool = False

    @property
    def K(self) -> int:
        return int(self.cols.shape[-1])

    @property
    def nnz(self) -> int:
        return int(np.asarray(self.nvalid).sum())

    def tree_flatten(self):
        return ((self.cols, self.vals, self.valid, self.nvalid),
                (self.n, self.m, self.int_exact))

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, vals, valid, nvalid = children
        n, m, int_exact = aux
        return cls(cols=cols, vals=vals, valid=valid, nvalid=nvalid,
                   n=n, m=m, int_exact=int_exact)


def _solver_dtype(vals: np.ndarray, dtype=None, m: int = 0):
    """Pick the solver dtype and exact-integer flag.

    Integers ride int32 (exact via (m+1) scaling) while the scaled range
    fits 2**26; larger integer costs are routed to float64 (exact while
    |cost| * (m+1) < 2**50) and solved on the native CPU path -- the
    device engines are f32/int32.  Floats default to float32
    (eps-optimal); pass
    dtype=np.float64 explicitly for reference-grade f64 tolerance on the
    CPU path.  Returns (np.dtype, int_exact: bool)."""
    if dtype is not None:
        d = np.dtype(dtype)
        return d, bool(d == np.float64 and
                       (np.issubdtype(vals.dtype, np.integer) or
                        np.issubdtype(vals.dtype, np.bool_)))
    if np.issubdtype(vals.dtype, np.integer) or \
            np.issubdtype(vals.dtype, np.bool_):
        vmax = int(np.abs(vals).max()) if vals.size else 0
        if vmax * (m + 1) < 2 ** 26:
            return np.dtype(np.int32), False
        if vmax * (m + 1) < 2 ** 50:
            return np.dtype(np.float64), True
        raise ValueError(
            f"integer costs too large for exact arithmetic: "
            f"max|cost| * (m+1) = {vmax * (m + 1):.3g} >= 2**50")
    return np.dtype(np.float32), False


def _build_ell_from_coo(
    rr: np.ndarray,
    cc: np.ndarray,
    vv: np.ndarray,
    n: int,
    m: int,
    dtype: np.dtype,
    pad_to: Optional[int] = None,
    int_exact: bool = False,
) -> ELLProblem:
    nnz = rr.shape[0]
    if nnz == 0:
        K = max(pad_to or 1, 1)
        return ELLProblem(
            cols=np.zeros((n, K), np.int32),
            vals=np.zeros((n, K), dtype),
            valid=np.zeros((n, K), bool),
            nvalid=np.zeros((n,), np.int32),
            n=n,
            m=m,
            int_exact=int_exact,
        )
    native = _native_builder()
    if native is not None:
        built = native(rr, cc, vv.astype(dtype, copy=False), n, m, dtype,
                       pad_to=pad_to)
        if built is not None:
            cols, vals, valid, counts, _ = built
            return ELLProblem(
                cols=cols, vals=vals, valid=valid,
                nvalid=counts.astype(np.int32), n=n, m=m,
                int_exact=int_exact,
            )
    # Numpy fallback path.
    # Sort by (row, col): within-row ascending columns give the deterministic
    # lowest-column-index argmax tie-break.
    order = np.lexsort((cc, rr))
    rr, cc, vv = rr[order], cc[order], vv[order]
    dup = (rr[1:] == rr[:-1]) & (cc[1:] == cc[:-1])
    if dup.any():
        raise ValueError("duplicate (row, col) entries in sparse input")
    counts = np.bincount(rr, minlength=n).astype(np.int64)
    K = int(counts.max())
    if pad_to is not None:
        K = max(K, int(pad_to))
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(nnz, dtype=np.int64) - starts[rr]

    cols = np.zeros((n, K), np.int32)
    vals = np.zeros((n, K), dtype)
    valid = np.zeros((n, K), bool)
    cols[rr, slot] = cc.astype(np.int32)
    vals[rr, slot] = vv.astype(dtype)
    valid[rr, slot] = True
    return ELLProblem(
        cols=cols,
        vals=vals,
        valid=valid,
        nvalid=counts.astype(np.int32),
        n=n,
        m=m,
        int_exact=int_exact,
    )


def from_dense(
    mat: np.ndarray,
    *,
    dtype=None,
    pad_to: Optional[int] = None,
    require_nonnegative: bool = True,
) -> ELLProblem:
    """Dense matrix -> ELLProblem.  Negative entries mark forbidden
    assignments (reference convention, SURVEY.md SS1 item 2); all valid costs
    must be >= 0 when ``require_nonnegative``.  NaN entries are forbidden."""
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError(f"dense cost matrix must be 2-D, got shape {mat.shape}")
    n, m = mat.shape
    if n > m:
        raise ValueError(
            f"rows ({n}) > cols ({m}); transpose so that rows <= cols"
        )
    if np.issubdtype(mat.dtype, np.floating):
        valid = (mat >= 0) & np.isfinite(mat)
    else:
        valid = mat >= 0
    rr, cc = np.nonzero(valid)
    vv = mat[rr, cc]
    del require_nonnegative  # the >= 0 mask already enforces it for dense
    sdt, int_exact = _solver_dtype(vv if vv.size else mat, dtype, m=m)
    return _build_ell_from_coo(
        rr.astype(np.int64), cc.astype(np.int64), vv, n, m, sdt,
        pad_to=pad_to, int_exact=int_exact,
    )


def from_coo(
    loc: np.ndarray,
    val: np.ndarray,
    *,
    shape: Optional[Tuple[int, int]] = None,
    dtype=None,
    pad_to: Optional[int] = None,
    require_nonnegative: bool = True,
) -> ELLProblem:
    """COO sparse input -> ELLProblem.

    ``loc``: int array [nnz, 2] of (row, col); ``val``: [nnz] costs.
    Shape is inferred from max indices unless given.  Mirrors the reference's
    sparse entry point (SURVEY.md SS4.2)."""
    loc = np.asarray(loc)
    val = np.asarray(val)
    if loc.ndim != 2 or loc.shape[1] != 2:
        raise ValueError(f"loc must have shape (nnz, 2), got {loc.shape}")
    if val.ndim != 1 or val.shape[0] != loc.shape[0]:
        raise ValueError("val must be 1-D with the same length as loc")
    if not np.issubdtype(loc.dtype, np.integer):
        raise ValueError("loc must be an integer array")
    rr = loc[:, 0].astype(np.int64)
    cc = loc[:, 1].astype(np.int64)
    if loc.shape[0] and (rr.min() < 0 or cc.min() < 0):
        raise ValueError("negative indices in loc")
    if shape is None:
        n = int(rr.max()) + 1 if rr.size else 0
        m = int(cc.max()) + 1 if cc.size else 0
    else:
        n, m = map(int, shape)
        if rr.size and (rr.max() >= n or cc.max() >= m):
            raise ValueError("loc indices out of bounds for given shape")
    if n > m:
        raise ValueError(
            f"rows ({n}) > cols ({m}); transpose so that rows <= cols"
        )
    if require_nonnegative and val.size and np.nanmin(val) < 0:
        raise ValueError(
            "all sparse costs must be >= 0 (negative marks 'forbidden' only "
            "in the dense path)"
        )
    if np.issubdtype(val.dtype, np.floating) and not np.isfinite(val).all():
        raise ValueError("non-finite values in val")
    sdt, int_exact = _solver_dtype(val, dtype, m=m)
    return _build_ell_from_coo(rr, cc, val, n, m, sdt,
                               pad_to=pad_to, int_exact=int_exact)


def from_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    *,
    shape: Optional[Tuple[int, int]] = None,
    dtype=None,
    pad_to: Optional[int] = None,
) -> ELLProblem:
    """CSR sparse input -> ELLProblem (convenience over from_coo)."""
    indptr = np.asarray(indptr)
    n = indptr.shape[0] - 1
    counts = np.diff(indptr).astype(np.int64)
    rr = np.repeat(np.arange(n, dtype=np.int64), counts)
    cc = np.asarray(indices).astype(np.int64)
    if shape is None:
        m = int(cc.max()) + 1 if cc.size else 0
        shape = (n, m)
    return from_coo(
        np.stack([rr, cc], axis=1), np.asarray(data), shape=shape, dtype=dtype,
        pad_to=pad_to,
    )


def to_coo(prob: ELLProblem) -> Tuple[np.ndarray, np.ndarray]:
    """ELLProblem -> (loc [nnz, 2], val [nnz]) of the stored valid entries
    (row-major order).  Inverse of from_coo up to entry order."""
    cols = np.asarray(prob.cols)
    vals = np.asarray(prob.vals)
    valid = np.asarray(prob.valid)
    rr = np.repeat(np.arange(prob.n, dtype=np.int64), prob.K) \
        .reshape(prob.n, prob.K)
    loc = np.stack([rr[valid], cols[valid].astype(np.int64)], axis=1)
    return loc, vals[valid]


def to_dense(prob: ELLProblem, forbidden_value=-1.0) -> np.ndarray:
    """ELLProblem -> dense numpy matrix (forbidden entries filled).  Test /
    debugging helper (round-trip oracle in tests/test_ingest.py)."""
    cols = np.asarray(prob.cols)
    vals = np.asarray(prob.vals)
    valid = np.asarray(prob.valid)
    out = np.full((prob.n, prob.m), forbidden_value,
                  dtype=np.result_type(vals.dtype, type(forbidden_value)))
    rr = np.repeat(np.arange(prob.n), prob.K).reshape(prob.n, prob.K)
    out[rr[valid], cols[valid]] = vals[valid]
    return out
