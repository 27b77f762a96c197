"""Analysis pass: per-row operation counts and global totals.

``analyze`` is the torch form of ``speck_tpu``'s device analysis: a gather
of B row lengths at A's column ids, then a cumulative-sum difference at
row boundaries, in int64: exact at any size. The int32 ``row_ops`` stays
exact while each row fits int32, and the f32 twin ``row_ops_f`` (each
row's count rounded once) detects the rows that do not.

``host_analyze``, ``host_gate_lite`` and ``host_band_extremes`` are numpy
forms of the reference's host gates: with the HostCSR copies attached,
planning needs no device sync for its routing decisions. They read the
same decisions at less cost: every band comes from ``row_ends`` (each
row's first and last column, one O(rows) gather from the ids as they
are), which a call's ``HostEnds`` builds once for each host copy and
shares between its steps; ``HostGateLite`` computes the product total
(``product_total``, a bincount over A's ids) only when a test reads it.
Each O(nnz) host pass of planning is counted in
``utils.timings.HOST_NNZ_PASSES``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.timings import host_pass, span, upload
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


def _count_le(sorted_pos: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """#(sorted_pos <= t) for every t (sorted_pos ascending): the
    run-length decode id[t] + 1 of the reference's boundary scatter-add
    and cumsum."""
    return torch.searchsorted(sorted_pos, t.contiguous(), right=True,
                              out_int32=True)


def _decode(boundary_pos, t):
    """Run-length id decode: id[t] = #(pos <= t) - 1 for ascending
    ``boundary_pos`` (the reference's base + in-chunk count, with base the
    number of boundaries before the chunk)."""
    return _count_le(boundary_pos, t.reshape(-1)).reshape(t.shape) - 1


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


@dataclasses.dataclass(frozen=True)
class RowEnds:
    """Each row's ends over a canonical CSR, int64: ``first`` and ``last``
    are every row's first and last column ids, meaningful where ``ne``
    (the row is not empty) holds; ``dfirst`` and ``dlast`` are the
    non-empty rows' ends less the row (a row's diagonal extremes)."""

    ne: np.ndarray
    first: np.ndarray
    last: np.ndarray
    dfirst: np.ndarray
    dlast: np.ndarray

    def band(self):
        """Exact (dmin, dmax) of (col - row); (INT32_MAX, -INT32_MAX)
        without an entry."""
        if self.dfirst.size == 0:
            return INT32_MAX, -INT32_MAX
        return int(self.dfirst.min()), int(self.dlast.max())


def row_ends(h) -> RowEnds:
    """``RowEnds`` of a host CSR: two gathers of ``rows`` column ids from
    the ids as they are (no copy of all of them), so O(rows) whatever the
    nonzero count."""
    ip = np.asarray(h.row_offsets, np.int64)
    ci = np.asarray(h.col_ids)
    n_r = ip.shape[0] - 1
    ne = ip[1:] > ip[:-1]
    if ci.shape[0] == 0:
        first = last = np.zeros(n_r, np.int64)
    else:
        # "wrap" keeps an empty row's offsets in range: its ends are
        # some row's, and ``ne`` masks them
        first = np.take(ci, ip[:-1], mode="wrap").astype(np.int64)
        last = np.take(ci, ip[1:] - 1, mode="wrap").astype(np.int64)
    rid = np.arange(n_r, dtype=np.int64)
    if ne.all():
        return RowEnds(ne=ne, first=first, last=last, dfirst=first - rid,
                       dlast=last - rid)
    rid = rid[ne]
    return RowEnds(ne=ne, first=first, last=last, dfirst=first[ne] - rid,
                   dlast=last[ne] - rid)


class HostEnds:
    """One call's ``RowEnds`` by host matrix: each built on its first use,
    inside the range ``speck.plan.row_ends``, and reused by the call's
    later steps (B's are A's where B is A's host copy). Holds nothing
    across calls."""

    def __init__(self) -> None:
        self._got = []

    def __call__(self, h) -> RowEnds:
        for k, v in self._got:
            if k is h:
                return v
        with span("speck.plan.row_ends"):
            v = row_ends(h)
        self._got.append((h, v))
        return v


def product_total(ah, bh) -> float:
    """The exact product total of A·B on the host: one bincount over A's
    column ids (an O(nnz) pass, counted in ``HOST_NNZ_PASSES``)."""
    host_pass("product_total")
    ci = np.asarray(ah.col_ids)
    b_ip = np.asarray(bh.row_offsets, np.int64)
    cnt_a = (np.bincount(ci, minlength=int(bh.rows)) if ci.size
             else np.zeros(int(bh.rows), np.int64))
    b_len = b_ip[1:] - b_ip[:-1]
    return float(np.dot(cnt_a[: b_len.shape[0]].astype(np.int64), b_len))


@dataclasses.dataclass
class HostGateLite:
    """Whole-matrix gate scalars without the per-row analysis; the exact
    product total (``sum_products``) is computed on its first read and
    kept in ``total`` (None until then)."""

    a_dmin: int
    a_dmax: int
    b_dmin: int
    b_dmax: int
    ah: object = dataclasses.field(repr=False, compare=False)
    bh: object = dataclasses.field(repr=False, compare=False)
    total: Optional[float] = dataclasses.field(default=None, repr=False,
                                               compare=False)

    @property
    def sum_products(self) -> float:
        if self.total is None:
            self.total = product_total(self.ah, self.bh)
        return self.total

    @property
    def sp_sat(self) -> int:
        return int(min(self.sum_products, 2.0 ** 31 - 2))


def host_band_extremes(ah, bh, ends: HostEnds):
    """(a_dmin, a_dmax, b_dmin, b_dmax), O(rows) from the call's row ends
    ``ends``."""
    return ends(ah).band() + ends(bh).band()


def host_gate_lite(ah, bh, extremes) -> HostGateLite:
    """The lite gate's scalars from ``host_band_extremes``' ``extremes``;
    the product total waits for its first read."""
    return HostGateLite(*extremes, ah=ah, bh=bh)


def host_analyze(ah, bh, ends: HostEnds) -> HostAnalysis:
    """Analysis + gate scalars on host numpy (exact int64): one O(nnz)
    pass, counted in ``HOST_NNZ_PASSES``; the bands from the call's row
    ends ``ends``."""
    host_pass("host_analyze")
    m = int(ah.rows)
    ip = np.asarray(ah.row_offsets, np.int64)
    ci = np.asarray(ah.col_ids)
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
    a_dmin, a_dmax, b_dmin, b_dmax = host_band_extremes(ah, bh, ends)
    return HostAnalysis(row_ops=row_ops, a_len=a_len,
                        sum_products=sum_products,
                        max_row_products=int(row_ops.max(initial=0)),
                        a_dmin=a_dmin, a_dmax=a_dmax, b_dmin=b_dmin,
                        b_dmax=b_dmax)
