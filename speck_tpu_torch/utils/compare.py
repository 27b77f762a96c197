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
