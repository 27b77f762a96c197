"""Host-side sparse containers: COO and CSR over numpy arrays.

A numpy copy of ``speck_tpu/formats/csr.py`` (that package imports jax,
this one must not). Duplicate (row, col) entries are kept, as the
reference's convert() keeps them; SpGEMM sums duplicate contributions, as
does the scipy oracle.

Two constructors carry matrices across from other containers without
importing them: ``HostCSR.from_parts`` takes the five fields as arrays, and
``HostCSR.from_host`` takes any object that has them (for example a
``speck_tpu`` HostCSR), so one matrix can feed both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class HostCOO:
    """Coordinate-format sparse matrix (host)."""

    rows: int
    cols: int
    row_ids: np.ndarray  # uint32/int64 (nnz,)
    col_ids: np.ndarray  # (nnz,)
    data: np.ndarray     # (nnz,) float32/float64

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass
class HostCSR:
    """Compressed-sparse-row matrix (host)."""

    rows: int
    cols: int
    row_offsets: np.ndarray  # (rows+1,) monotone, row_offsets[-1] == nnz
    col_ids: np.ndarray      # (nnz,)
    data: np.ndarray         # (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_offsets)

    def row_statistics(self):
        """Row-length statistics (mean, sample std, max, min)."""
        lengths = self.row_lengths().astype(np.float64)
        count = lengths.shape[0]
        mean = float(lengths.mean()) if count else 0.0
        std_dev = float(lengths.std(ddof=1)) if count >= 2 else 0.0
        mx = int(lengths.max()) if count else 0
        mn = int(lengths.min()) if count else self.cols
        return {"mean": mean, "std_dev": std_dev, "max": mx, "min": mn}

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data, self.col_ids, self.row_offsets), shape=self.shape
        )

    @staticmethod
    def from_scipy(m) -> "HostCSR":
        m = m.tocsr()
        return HostCSR(
            rows=int(m.shape[0]),
            cols=int(m.shape[1]),
            row_offsets=np.asarray(m.indptr, dtype=np.uint32),
            col_ids=np.asarray(m.indices, dtype=np.uint32),
            data=np.asarray(m.data),
        )

    @staticmethod
    def from_parts(rows, cols, row_offsets, col_ids, data) -> "HostCSR":
        """A HostCSR over the given arrays (no copy where numpy needs none)."""
        return HostCSR(
            rows=int(rows),
            cols=int(cols),
            row_offsets=np.asarray(row_offsets),
            col_ids=np.asarray(col_ids),
            data=np.asarray(data),
        )

    @staticmethod
    def from_host(h) -> "HostCSR":
        """A HostCSR from any object with ``rows``, ``cols``,
        ``row_offsets``, ``col_ids`` and ``data`` attributes."""
        return HostCSR.from_parts(h.rows, h.cols, h.row_offsets, h.col_ids,
                                  h.data)


def coo_to_csr(coo: HostCOO) -> HostCSR:
    """COO->CSR conversion, duplicates kept, stable within (row, col): the
    native counting sort (``speck_tpu_torch.native``), or a numpy lexsort
    where the library is unavailable."""
    from ..native import coo_to_csr_native

    native = coo_to_csr_native(coo.row_ids, coo.col_ids, coo.data, coo.rows)
    if native is not None:
        offsets, cols, vals = native
        return HostCSR(rows=coo.rows, cols=coo.cols, row_offsets=offsets,
                       col_ids=cols, data=vals)
    order = np.lexsort((coo.col_ids, coo.row_ids))
    row_ids = coo.row_ids[order]
    counts = np.bincount(row_ids, minlength=coo.rows).astype(np.uint32)
    row_offsets = np.zeros(coo.rows + 1, dtype=np.uint32)
    np.cumsum(counts, out=row_offsets[1:])
    return HostCSR(
        rows=coo.rows,
        cols=coo.cols,
        row_offsets=row_offsets,
        col_ids=coo.col_ids[order].astype(np.uint32),
        data=coo.data[order],
    )


def csr_transpose(a: HostCSR) -> HostCSR:
    """Host CSR transpose (stable counting sort by column)."""
    counts = np.bincount(a.col_ids, minlength=a.cols).astype(np.int64)
    out_offsets = np.zeros(a.cols + 1, dtype=np.int64)
    np.cumsum(counts, out=out_offsets[1:])
    rows = np.repeat(np.arange(a.rows, dtype=np.int64), a.row_lengths())
    order = np.argsort(a.col_ids, kind="stable")
    return HostCSR(
        rows=a.cols,
        cols=a.rows,
        row_offsets=out_offsets.astype(np.uint32),
        col_ids=rows[order].astype(np.uint32),
        data=a.data[order],
    )
