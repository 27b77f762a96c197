"""Reference SpGEMM oracle (scipy.sparse on the host, float64).

A copy of ``speck_tpu/utils/oracle.py``. The structure is the set of
(row, col) pairs with at least one contributing product, so entries whose
products cancel to exactly 0.0 are kept (scipy would prune them)."""

from __future__ import annotations

import numpy as np

from ..formats.csr import HostCSR


def oracle_spgemm(a, b, dtype=np.float64) -> HostCSR:
    """C = A @ B on the host in float64 via scipy.sparse."""
    import scipy.sparse as sp

    A = sp.csr_matrix((a.data.astype(np.float64), a.col_ids.astype(np.int64),
                       a.row_offsets.astype(np.int64)), shape=a.shape)
    B = sp.csr_matrix((b.data.astype(np.float64), b.col_ids.astype(np.int64),
                       b.row_offsets.astype(np.int64)), shape=b.shape)
    # structure from a pattern product (all-positive: no cancellation),
    # values grafted in from the numeric product
    Ap = A.copy()
    Ap.data = np.ones_like(Ap.data)
    Bp = B.copy()
    Bp.data = np.ones_like(Bp.data)
    P = Ap @ Bp
    P.sort_indices()
    C = A @ B
    C.sort_indices()
    data = np.zeros(P.nnz, dtype=np.float64)
    if C.nnz:
        n64 = np.int64(P.shape[1]) + 1
        rows_p = np.repeat(np.arange(P.shape[0], dtype=np.int64),
                           np.diff(P.indptr))
        rows_c = np.repeat(np.arange(C.shape[0], dtype=np.int64),
                           np.diff(C.indptr))
        pos = np.searchsorted(rows_p * n64 + P.indices,
                              rows_c * n64 + C.indices)
        data[pos] = C.data
    return HostCSR(rows=int(P.shape[0]), cols=int(P.shape[1]),
                   row_offsets=np.asarray(P.indptr, dtype=np.int64),
                   col_ids=np.asarray(P.indices, dtype=np.int64),
                   data=data.astype(dtype))
