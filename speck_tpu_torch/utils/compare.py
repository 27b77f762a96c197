"""Structural/numerical CSR comparison for differential validation
(a copy of ``speck_tpu/utils/compare.py``): per-row lengths and column ids
exact, values optionally at a relative tolerance; reports the first
mismatching row."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CompareResult:
    ok: bool
    message: str = "match"
    row: Optional[int] = None

    def __bool__(self) -> bool:
        return self.ok


def compare_csr(reference, result, compare_data: bool = False,
                rel_tol: float = 0.01,
                abs_tol: Optional[float] = None) -> CompareResult:
    """Structure-exact, values-at-tolerance CSR comparison.

    abs_tol floors the value check for near-zero entries (fp32 products
    cancelling toward 0 have unbounded relative error against an f64
    oracle). Default: rel_tol * max|ref| * 1e-4."""
    if reference.shape != result.shape:
        return CompareResult(
            False, f"shape mismatch {reference.shape} != {result.shape}")
    ref_off = np.asarray(reference.row_offsets, dtype=np.int64)
    res_off = np.asarray(result.row_offsets, dtype=np.int64)
    if ref_off.shape != res_off.shape:
        return CompareResult(False, "row_offsets length mismatch")
    len_ok = np.diff(ref_off) == np.diff(res_off)
    if not len_ok.all():
        row = int(np.argmin(len_ok))
        return CompareResult(
            False,
            f"row {row} length mismatch: ref={ref_off[row+1]-ref_off[row]}"
            f" got={res_off[row+1]-res_off[row]}", row)
    if reference.nnz != result.nnz:
        return CompareResult(
            False, f"nnz mismatch {reference.nnz} != {result.nnz}")
    cols_ok = (np.asarray(reference.col_ids, np.int64)
               == np.asarray(result.col_ids, np.int64))
    if not cols_ok.all():
        pos = int(np.argmin(cols_ok))
        row = int(np.searchsorted(ref_off, pos, side="right")) - 1
        return CompareResult(
            False, f"row {row} column mismatch at nnz {pos}:"
            f" ref={reference.col_ids[pos]} got={result.col_ids[pos]}", row)
    if compare_data:
        ref_d = np.asarray(reference.data, np.float64)
        res_d = np.asarray(result.data, np.float64)
        denom = np.maximum(np.abs(ref_d), np.abs(res_d))
        if abs_tol is None:
            scale = float(np.abs(ref_d).max()) if ref_d.size else 0.0
            abs_tol = rel_tol * scale * 1e-4
        bad = (np.abs(ref_d - res_d)
               > rel_tol * np.maximum(denom, 1e-300) + abs_tol)
        bad &= denom > 0
        if bad.any():
            pos = int(np.argmax(bad))
            row = int(np.searchsorted(ref_off, pos, side="right")) - 1
            return CompareResult(
                False, f"row {row} value mismatch at nnz {pos}:"
                f" ref={ref_d[pos]} got={res_d[pos]}", row)
    return CompareResult(True)


# unit roundoff of each value type (half the spacing of 1.0), and half
# its smallest subnormal (the absolute error of a rounding that underflows)
UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11,
                 "float32": 2.0 ** -24, "float64": 2.0 ** -53}
UNDERFLOW = {"bfloat16": 2.0 ** -134, "float16": 2.0 ** -25,
             "float32": 2.0 ** -150, "float64": 2.0 ** -1075}


def _on_pattern(P, M) -> np.ndarray:
    """M's values at the entries of P (sorted CSR; M's entries are a
    subset of P's, scipy having pruned its zeros), 0 elsewhere."""
    n64 = np.int64(P.shape[1]) + 1
    out = np.zeros(P.nnz, np.float64)
    if M.nnz:
        rows_p = np.repeat(np.arange(P.shape[0], dtype=np.int64),
                           np.diff(P.indptr))
        rows_m = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                           np.diff(M.indptr))
        out[np.searchsorted(rows_p * n64 + P.indices,
                            rows_m * n64 + M.indices)] = M.data
    return out


def product_magnitudes(a, b):
    """(n, mag) on the pattern of A @ B (its entries with a product, in
    sorted CSR order): n_ij the number of products summed into (i, j) and
    mag_ij = (|A| |B|)_ij, both float64."""
    import scipy.sparse as sp

    def csr(h, data):
        m = sp.csr_matrix((data, np.asarray(h.col_ids, np.int64),
                           np.asarray(h.row_offsets, np.int64)),
                          shape=h.shape)
        m.sort_indices()
        return m

    P = csr(a, np.ones(a.nnz)) @ csr(b, np.ones(b.nnz))
    P.sort_indices()
    M = (csr(a, np.abs(np.asarray(a.data, np.float64)))
         @ csr(b, np.abs(np.asarray(b.data, np.float64))))
    M.sort_indices()
    return P.data, _on_pattern(P, M)


def compare_csr_bound(a, b, result, dtype) -> CompareResult:
    """Structure exact, and every value within the rounding bound of a sum
    of rounded products: |C - C_ref| <= 2 (n_ij + 1) (u (|A| |B|)_ij +
    eta), with
    C_ref the float64 product of ``a`` and ``b`` (the inputs as rounded to
    their value types), n_ij the number of products summed into (i, j), u
    the unit roundoff of ``dtype`` (C's type; a torch or numpy type or its
    name) and eta half its smallest subnormal. Twice the textbook bound of
    a recursive sum of n rounded products, in the standard model with
    underflow (float16's subnormals start at 2^-14: a product below that
    is rounded to a fixed absolute spacing, which no relative bound
    covers), so it holds for 16-bit sums and for sums taken in float and
    rounded once alike."""
    from .oracle import oracle_spgemm

    ref = oracle_spgemm(a, b)
    r = compare_csr(ref, result)
    if not r.ok:
        return r
    name = str(dtype).replace("torch.", "").split(".")[-1]
    u, eta = UNIT_ROUNDOFF[name], UNDERFLOW[name]
    n, mag = product_magnitudes(a, b)
    err = np.abs(np.asarray(result.data, np.float64)
                 - np.asarray(ref.data, np.float64))
    bound = 2.0 * (n + 1.0) * (u * mag + eta)
    bad = err > bound
    if bad.any():
        pos = int(np.argmax(bad))
        row = int(np.searchsorted(np.asarray(ref.row_offsets, np.int64), pos,
                                  side="right")) - 1
        return CompareResult(
            False, f"row {row} value past the {dtype} bound at nnz {pos}:"
            f" ref={ref.data[pos]} got={result.data[pos]}"
            f" bound={bound[pos]}", row)
    return CompareResult(True)
