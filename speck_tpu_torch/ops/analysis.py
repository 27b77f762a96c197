"""Analysis pass: per-row operation counts and global totals.

``analyze`` is the torch form of ``speck_tpu``'s device analysis: a gather
of B row lengths at A's column ids, then a cumulative-sum difference at
row boundaries, in int64: exact at any size. The int32 ``row_ops`` stays
exact while each row fits int32, and the f32 twin ``row_ops_f`` (each
row's count rounded once) detects the rows that do not.

``host_analyze``, ``host_gate_lite`` and ``host_band_extremes`` are numpy
copies of the reference's host forms: with the HostCSR copies attached,
planning needs no device sync for its routing decisions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.timings import upload
from .device_csr import DeviceCSR

INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class AnalysisResult:
    row_ops: torch.Tensor                 # (m,) int32 products per row
    a_len: Optional[torch.Tensor]         # (m,) int32 nnz per row of A
    work: Optional[torch.Tensor]          # (m,) int32 max(row_ops, a_len)
    sum_products: torch.Tensor            # () float32 total products
    max_work: torch.Tensor                # () int32
    row_ops_f: Optional[torch.Tensor]     # (m,) float32 wrap-immune twin


def cumsum1d(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum in the input's dtype (int32 stays int32)."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def _analyze_impl(a_indptr, a_indices, b_indptr, m: int) -> AnalysisResult:
    a_len = a_indptr[1:] - a_indptr[:-1]
    blen = b_indptr[a_indices + 1] - b_indptr[a_indices]
    # per-row products as differences of an int64 cumulative sum: exact at
    # any size, so the decisions taken on them are the same on the CPU and
    # the card (a float32 cumulative sum rounds past 2^24 products, each
    # device in its own order). row_ops is their int32 form (wrapped past
    # 2^31 products a row, as an int32 cumulative sum's differences are),
    # row_ops_f each row's count rounded once to float32
    zero = torch.zeros(1, dtype=torch.int64, device=a_indptr.device)
    cse = torch.cat([zero, torch.cumsum(blen, 0, dtype=torch.int64)])
    ops = cse[a_indptr[1:]] - cse[a_indptr[:-1]]
    row_ops = ops.to(torch.int32)
    row_ops_f = ops.to(torch.float32)
    work = torch.maximum(row_ops, a_len)
    max_work = (work.max() if m > 0 else
                torch.zeros((), dtype=torch.int32, device=a_indptr.device))
    return AnalysisResult(row_ops=row_ops, a_len=a_len, work=work,
                          sum_products=ops.sum().to(torch.float32),
                          max_work=max_work, row_ops_f=row_ops_f)


def analyze(A: DeviceCSR, B: DeviceCSR) -> AnalysisResult:
    """Run the analysis pass on A's device."""
    return _analyze_impl(A.indptr, A.indices, B.indptr, A.shape[0])


@dataclasses.dataclass(frozen=True)
class HostAnalysis:
    """Host (numpy) analysis plus the 7 routing/guard gate scalars."""

    row_ops: np.ndarray       # (m,) int64 exact products per row
    a_len: np.ndarray         # (m,) int64 nnz per row of A
    sum_products: float       # exact
    max_row_products: int     # exact
    a_dmin: int               # min/max of (col - row) over A and B
    a_dmax: int
    b_dmin: int
    b_dmax: int

    @property
    def sp_sat(self) -> int:
        return int(min(self.sum_products, 2.0 ** 31 - 2))

    @property
    def mxrow_sat(self) -> int:
        return int(min(self.max_row_products, 2 ** 31 - 2))

    def to_device(self, device) -> AnalysisResult:
        """Upload only row_ops (int32, without a synchronize); the planner
        derives a_len and row_ops_f on the device."""
        work_max = int(np.maximum(self.row_ops, self.a_len).max(initial=0))
        return AnalysisResult(
            row_ops=upload(self.row_ops.astype(np.int32), device),
            a_len=None, work=None,
            sum_products=torch.tensor(self.sum_products,
                                      dtype=torch.float32),
            max_work=torch.tensor(min(work_max, INT32_MAX),
                                  dtype=torch.int32),
            row_ops_f=None,
        )


def _host_band(ipx, cix, rows):
    """Exact (dmin, dmax) of (col - row) over a canonical CSR: a row's
    diagonal extremes are its first and last column ids."""
    n_r = int(rows)
    nz = cix.shape[0]
    if nz == 0 or n_r == 0:
        return INT32_MAX, -INT32_MAX
    lenx = ipx[1:] - ipx[:-1]
    ne = lenx > 0
    if not ne.any():
        return INT32_MAX, -INT32_MAX
    ridx = np.arange(n_r, dtype=np.int64)
    first = cix[np.minimum(ipx[:-1], nz - 1)] - ridx
    last = cix[np.maximum(ipx[1:] - 1, 0)] - ridx
    return int(first[ne].min()), int(last[ne].max())


@dataclasses.dataclass(frozen=True)
class HostGateLite:
    """Whole-matrix gate scalars without the per-row analysis."""

    a_dmin: int
    a_dmax: int
    b_dmin: int
    b_dmax: int
    sum_products: float    # exact

    @property
    def sp_sat(self) -> int:
        return int(min(self.sum_products, 2.0 ** 31 - 2))


def host_band_extremes(ah, bh):
    """(a_dmin, a_dmax, b_dmin, b_dmax), O(rows)."""
    a_dmin, a_dmax = _host_band(np.asarray(ah.row_offsets, np.int64),
                                np.asarray(ah.col_ids), ah.rows)
    if bh is ah:
        return a_dmin, a_dmax, a_dmin, a_dmax
    b_dmin, b_dmax = _host_band(np.asarray(bh.row_offsets, np.int64),
                                np.asarray(bh.col_ids), bh.rows)
    return a_dmin, a_dmax, b_dmin, b_dmax


def host_gate_lite(ah, bh, extremes=None) -> HostGateLite:
    if extremes is None:
        extremes = host_band_extremes(ah, bh)
    a_dmin, a_dmax, b_dmin, b_dmax = extremes
    ci = np.asarray(ah.col_ids)
    b_ip = np.asarray(bh.row_offsets, np.int64)
    cnt_a = (np.bincount(ci, minlength=int(bh.rows)) if ci.size
             else np.zeros(int(bh.rows), np.int64))
    b_len = b_ip[1:] - b_ip[:-1]
    sum_products = float(np.dot(cnt_a[: b_len.shape[0]].astype(np.int64),
                                b_len))
    return HostGateLite(a_dmin=a_dmin, a_dmax=a_dmax, b_dmin=b_dmin,
                        b_dmax=b_dmax, sum_products=sum_products)


def host_analyze(ah, bh) -> HostAnalysis:
    """Analysis + gate scalars on host numpy (exact int64)."""
    m = int(ah.rows)
    ip = np.asarray(ah.row_offsets, np.int64)
    ci = np.asarray(ah.col_ids, np.intp)
    b_ip = np.asarray(bh.row_offsets, np.int64)
    b_len = b_ip[1:] - b_ip[:-1]
    a_len = ip[1:] - ip[:-1]
    blen_a = b_len[ci]
    if ci.shape[0]:
        # reduceat needs in-range starts and returns g2[start] for empty
        # rows: a zero sentinel plus a mask fixes both
        g2 = np.concatenate([blen_a, np.zeros(1, np.int64)])
        row_ops = np.add.reduceat(g2, ip[:-1])
        row_ops[a_len == 0] = 0
        sum_products = float(blen_a.sum(dtype=np.int64))
    else:
        row_ops = np.zeros(m, np.int64)
        sum_products = 0.0
    a_dmin, a_dmax = _host_band(ip, ci, m)
    if bh is ah:
        b_dmin, b_dmax = a_dmin, a_dmax
    else:
        b_dmin, b_dmax = _host_band(b_ip, np.asarray(bh.col_ids, np.intp),
                                    bh.rows)
    return HostAnalysis(row_ops=row_ops, a_len=a_len,
                        sum_products=sum_products,
                        max_row_products=int(row_ops.max(initial=0)),
                        a_dmin=a_dmin, a_dmax=a_dmax, b_dmin=b_dmin,
                        b_dmax=b_dmax)
