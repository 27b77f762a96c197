"""Diagonal-plane SpGEMM (torch port of ``speck_tpu/ops/dia.py``).

Write A = sum_d diag(a_d) S^d (S the shift operator, a_d the d-th diagonal
as a length-m vector indexed by row). Then

    C[i, i+e] = sum_{d1+d2=e} a_{d1}[i] * b_{d2}[i+d1]

so every output diagonal is a short sum of elementwise products of
A-diagonals with row-shifted B-diagonals: no gathers, no sorts. Structure
comes from the same convolution applied to 0/1 presence ("hit") planes.

Two flavours share the planes, the staging and the emission:

  contiguous DIA   planes over a diagonal RANGE [dmin, dmax] (banded FEM
                   matrices, bench config 1): ``dia_conv``;
  sparse DIA       planes over explicit present-offset LISTS (the 3-D
                   stencil class): ``sdia_conv``, every pair (da, db) one
                   multiply-add into the plane of da + db.

The per-row DIA split runs the contiguous convolution over masked planes
(only the rows the planner routed there) and scatters its entries into
the C that the other routes share (``dia_scatter_emit``).

Port conventions (see ops/stream.py): the reference's scatters with
``mode="drop"`` target a buffer with one trailing drop slot; run-length
decodes of row ids and forward fills are ``torch.searchsorted`` over
``indptr``. The plane scatters are ``index_add_`` (the slots of a
canonical input are unique, so the sums are exact and order-free). The
convolutions are in-place ``addcmul_`` over plane slices in the
reference's order of summation; only FMA contraction may differ. The rank
compaction is one scatter of unique indices for both the counting and the
numeric pass, the reference's ``impl="scatter"`` form: it equals the
reference's rank sort (``impl="sort"``) on every slot (absent slots hold
col ``n_cols`` and value 0 and are never emitted), so both settings of
``stream_compact_impl`` stage the same planes here.

Value types as in the reference: the planes keep each operand's type,
the contiguous convolution accumulates in A's type and raises TypeError
where the product's promoted type is wider (the reference's
``dynamic_update_slice`` refuses it: a 16-bit A times a wider B, or
float32 times float64), and the sparse convolution's planes take the
promoted type. 16-bit planes convolve in their own type, as the
reference's ``jnp`` does.
Unlike the reference, ``sdia_conv`` runs each pair over all rows at once:
the row blocking there only bounded XLA's compile-time temporaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .stream import _count_le

I32 = torch.int32


@dataclasses.dataclass
class DiaState:
    """Host and device state of a DIA-routed plan.

    Contiguous DIA (``off_a is None``): span_* are diagonal ranges. Sparse
    DIA: ``off_a``/``off_b`` are the present-offset lists, span_* the plane
    counts nd_a, nd_b, nd_c, and ``doffs`` maps output plane -> offset."""

    span_a: int
    span_b: int
    span_c: int
    dmin_a: int
    dmin_b: int
    slot_a: torch.Tensor            # (nnz_a,) plane slot of each A nonzero
    slot_b: torch.Tensor            # (nnz_b,) plane slot of each B nonzero
    present: torch.Tensor           # (m, span_c) bool structural presence
    staged: Optional[tuple] = None  # (cols_s, vals_s), each (m, span_c)
    # uniform-rows fast emit: rows [p, q) are all full, their staged block
    # is the final payload at shift offs_p
    uniform: Optional[tuple] = None  # (p, q, offs_p)
    off_a: Optional[tuple] = None
    off_b: Optional[tuple] = None
    doffs: Optional[torch.Tensor] = None


def plane_bytes(m: int, k: int, n_out: int, sa: int, sb: int,
                itemsize: int = 4) -> int:
    """Peak working set of the DIA pipeline (planes, shifted B, output
    planes, staged compaction), for the planner's memory gate."""
    sc = sa + sb - 1
    return itemsize * (
        2 * sa * m            # A value+hit planes
        + 2 * sb * k          # B value+hit planes
        + 2 * sb * (m + sa)   # shifted B planes
        + 2 * sc * m          # C value+count planes
        + 3 * sc * m          # staged cols/vals + present
    )


def row_ids(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Row of every CSR nonzero: #(row ends <= t), the reference's
    boundary scatter-add and cumsum."""
    return _count_le(indptr[1:], torch.arange(nnz, dtype=I32,
                                              device=indptr.device))


def dia_slots(indptr, indices, row_keep=None, *, dmin: int, span: int,
              rows: int, masked: bool = False):
    """Flat plane slot of every nonzero: (col - row - dmin) * rows + row.

    masked (per-row DIA split): nonzeros of rows with ``row_keep`` False
    get the drop slot span * rows, so the planes hold only the kept rows'
    contributions."""
    nnz = indices.shape[0]
    if nnz == 0:
        return torch.zeros(0, dtype=I32, device=indices.device)
    rid = row_ids(indptr, nnz)
    d = indices - rid - dmin
    # out-of-band entries cannot exist when the band stats are exact
    # (canonical inputs); clip so a bad input cannot leave the planes
    slot = torch.clamp(d, 0, span - 1) * rows + rid
    if masked:
        slot = torch.where(row_keep[rid], slot, span * rows)
    return slot.to(I32)


def dia_row_inband(indptr, indices, *, dmin: int, dmax: int):
    """Per-row in-band mask: every nonzero of the row has (col - row) in
    [dmin, dmax] (exact for canonical rows by the first and last column);
    empty rows are in band."""
    rows = indptr.shape[0] - 1
    ne = (indptr[1:] - indptr[:-1]) > 0
    nnz = indices.shape[0]
    if nnz == 0:
        return ~ne
    rowi = torch.arange(rows, dtype=I32, device=indptr.device)
    first = indices[torch.clamp(indptr[:-1], max=nnz - 1)] - rowi
    last = indices[torch.clamp(indptr[1:] - 1, min=0)] - rowi
    return (~ne) | ((first >= dmin) & (last <= dmax))


def dia_planes(slot, data, *, span: int, rows: int):
    """Value and presence planes from the slots: val[d, i] = the entry on
    diagonal d at row i; hit marks structural presence (explicit zeros
    included). The trailing slot takes the dropped (masked) entries."""
    size = span * rows
    dev = data.device
    val = torch.zeros(size + 1, dtype=data.dtype, device=dev)
    val.index_add_(0, slot, data)
    hit = torch.zeros(size + 1, dtype=torch.float32, device=dev)
    hit.index_add_(0, slot, torch.ones(slot.shape[0], dtype=torch.float32,
                                       device=dev))
    return val[:size].view(span, rows), hit[:size].view(span, rows)


def dia_conv(a_val, a_hit, b_val, b_hit, *, sa: int, sb: int, m: int,
             k: int, dmin_a: int, with_hit: bool):
    """The diagonal convolution C[e, i] = sum_{j1} A[j1, i] *
    B[e - j1, i + dmin_a + j1], as sa in-place multiply-adds over (sb, m)
    slices in the reference's j1 order. The B planes are first shifted by
    dmin_a (zero pad and slice), so B row i + dmin_a + j1 is column j1 + i.
    Returns (C_val (sc, m), C_cnt (sc, m) or None)."""
    if torch.promote_types(a_val.dtype, b_val.dtype) != a_val.dtype:
        raise TypeError(
            f"the diagonal convolution accumulates in A's {a_val.dtype} "
            f"and cannot take {b_val.dtype} products (speck_tpu raises "
            "here too)")
    sc = sa + sb - 1
    wt = m + sa - 1          # shifted-plane width
    pad_l = max(0, -dmin_a)
    pad_r = max(0, (wt + dmin_a) - k)
    s0 = dmin_a + pad_l

    def shift(planes):
        p = torch.nn.functional.pad(planes, (pad_l, pad_r))
        return p[:, s0: s0 + wt]

    pairs = [(a_val, shift(b_val),
              torch.zeros((sc, m), dtype=a_val.dtype, device=a_val.device))]
    if with_hit:
        pairs.append((a_hit, shift(b_hit),
                      torch.zeros((sc, m), dtype=torch.float32,
                                  device=a_val.device)))
    for a, bp, c in pairs:
        for j1 in range(sa):
            c[j1: j1 + sb].addcmul_(a[j1][None, :], bp[:, j1: j1 + m])
    return pairs[0][2], (pairs[1][2] if with_hit else None)


# ---------------------------------------------------------------------------
# Sparse DIA: planes indexed by an explicit offset list (the stencil class)
# ---------------------------------------------------------------------------


def sdia_lut(offs, dmin: int, span: int) -> np.ndarray:
    """Host (span,) lookup table: diagonal (d - dmin) -> plane index."""
    lut = np.zeros(span, np.int32)
    lut[np.asarray(offs, np.int64) - dmin] = np.arange(len(offs),
                                                       dtype=np.int32)
    return lut


def sdia_slots(indptr, indices, lut, *, dmin: int, rows: int):
    """Flat plane slot of every nonzero for list-indexed planes:
    lut[col - row - dmin] * rows + row (every nonzero lies on a present
    diagonal by construction of the list)."""
    nnz = indices.shape[0]
    if nnz == 0:
        return torch.zeros(0, dtype=I32, device=indices.device)
    rid = row_ids(indptr, nnz)
    d = torch.clamp(indices - rid - dmin, 0, lut.shape[0] - 1)
    return (lut[d] * rows + rid).to(I32)


def sdia_pad(off_a, m: int, k: int):
    """B-plane padding that makes every per-pair shift an in-range slice:
    (pad_l, pad_r)."""
    return max(0, -min(off_a)), max(0, m + max(off_a) - k)


def sdia_plane_bytes(m: int, k: int, nd_a: int, nd_b: int, nd_c: int,
                     pad_w: int, itemsize: int = 4) -> int:
    """Peak working set of the sparse-DIA pipeline (memory gate)."""
    return itemsize * (
        2 * nd_a * m          # A value+hit planes
        + 2 * nd_b * k        # B value+hit planes
        + 2 * nd_b * pad_w    # padded B planes
        + 2 * nd_c * m        # C value+count planes
        + 3 * nd_c * m        # staged cols/vals + present
    )


def sdia_conv(a_val, a_hit, b_val, b_hit, *, off_a: tuple, off_b: tuple,
              off_c: tuple, m: int, k: int, with_hit: bool):
    """List-offset diagonal convolution: for every pair (da, db),
    C_plane[index of da + db] += a_val[da] * b_val[db] shifted by da. Each
    output plane sums its pairs from zero in the reference's group order,
    one in-place multiply-add over all m rows per pair."""
    pad_l, pad_r = sdia_pad(off_a, m, k)
    oc_index = {d: i for i, d in enumerate(off_c)}
    groups: dict = {}      # output plane -> [(ia, da, ib)], in order
    for ia, da in enumerate(off_a):
        for ib, db in enumerate(off_b):
            groups.setdefault(oc_index[da + db], []).append((ia, da, ib))
    nd_c = len(off_c)

    def conv(a, b, dtype):
        bp = torch.nn.functional.pad(b, (pad_l, pad_r))
        c = torch.zeros((nd_c, m), dtype=dtype, device=a.device)
        for oc in range(nd_c):
            for ia, da, ib in groups.get(oc, ()):
                s0 = pad_l + da
                c[oc].addcmul_(a[ia], bp[ib, s0: s0 + m])
        return c

    c_val = conv(a_val, b_val, torch.promote_types(a_val.dtype,
                                                   b_val.dtype))
    c_cnt = conv(a_hit, b_hit, torch.float32) if with_hit else None
    return c_val, c_cnt


# ---------------------------------------------------------------------------
# Fused pipelines, staging and emission
# ---------------------------------------------------------------------------


def dia_count_pipeline(slot_a, a_data, slot_b, b_data, *, sa: int, sb: int,
                       m: int, k: int, dmin_a: int, sc: int, n_cols: int,
                       base_c: int, same: bool):
    """Planes, convolution and count/stage of a contiguous-DIA plan."""
    av, ah = dia_planes(slot_a, a_data, span=sa, rows=m)
    bv, bh = (av, ah) if same else dia_planes(slot_b, b_data, span=sb,
                                              rows=k)
    c_val, c_cnt = dia_conv(av, ah, bv, bh, sa=sa, sb=sb, m=m, k=k,
                            dmin_a=dmin_a, with_hit=True)
    return dia_count_stage(c_val, c_cnt, sc=sc, m=m, n_cols=n_cols,
                           base_c=base_c)


def dia_rows_conv_fused(slot_a, a_data, slot_b, b_data, *, sa: int, sb: int,
                        m: int, k: int, dmin_a: int, with_hit: bool,
                        same: bool = False):
    """Planes and convolution for the per-row DIA split."""
    av, ah = dia_planes(slot_a, a_data, span=sa, rows=m)
    bv, bh = (av, ah) if same else dia_planes(slot_b, b_data, span=sb,
                                              rows=k)
    return dia_conv(av, ah, bv, bh, sa=sa, sb=sb, m=m, k=k, dmin_a=dmin_a,
                    with_hit=with_hit)


def _rank_compact(cvT, present, *, sc: int, m: int, n_cols: int,
                  base_c: int, doffs=None):
    """Each row's present entries moved to the front in diagonal order
    (ascending column order within a row), as one scatter to i * sc +
    rank; the rest hold col ``n_cols`` and value 0. ``doffs`` (sparse
    DIA): per-plane diagonal offsets in place of base_c + e. This is the
    reference's ``impl="scatter"``; its rank sort (``impl="sort"``)
    stages the same planes, so every ``stream_compact_impl`` runs it."""
    dev = present.device
    e = torch.arange(sc, dtype=I32, device=dev)[None, :]
    i = torch.arange(m, dtype=I32, device=dev)[:, None]
    col_of_e = (base_c + e) if doffs is None else doffs[None, :]
    rank = torch.cumsum(present, dim=1, dtype=I32) - 1
    flat = torch.where(present, i * sc + rank, m * sc).reshape(-1)
    cols_s = torch.full((m * sc + 1,), n_cols, dtype=I32, device=dev)
    cols_s[flat] = (i + col_of_e).to(I32).reshape(-1)
    vals_s = torch.zeros(m * sc + 1, dtype=cvT.dtype, device=dev)
    vals_s[flat] = cvT.reshape(-1)
    return cols_s[:-1].view(m, sc), vals_s[:-1].view(m, sc)


def dia_count_stage(c_val, c_cnt, doffs=None, *, sc: int, m: int,
                    n_cols: int, base_c: int):
    """Counting and staging from the output planes: transpose to rows,
    then compact each row's present entries to the front (columns come
    out sorted). Returns (nnz_row, present, cols_s, vals_s)."""
    present = c_cnt.t() > 0.5          # exact: fp32 sums of 1.0
    counts = torch.sum(present, dim=1, dtype=I32)
    cols_s, vals_s = _rank_compact(c_val.t(), present, sc=sc, m=m,
                                   n_cols=n_cols, base_c=base_c, doffs=doffs)
    return counts, present, cols_s, vals_s


def dia_numeric_stage(c_val, present, doffs=None, *, sc: int, m: int,
                      n_cols: int, base_c: int):
    """Numeric re-staging against a known structure (plan reuse): the
    stored presence decides, so value cancellation cannot change it."""
    return _rank_compact(c_val.t(), present, sc=sc, m=m, n_cols=n_cols,
                         base_c=base_c, doffs=doffs)


def dia_offsets_meta(counts, *, sc: int):
    """Row offsets and the uniform-run scalars for ONE readback: meta =
    [nnz, max_count, p, q, run_ok, offs_p], [p, q) the rows between the
    first and the last full row (count == sc), run_ok = 1 iff every row
    in it is full and none outside is; then the staged rows [p, q) are the
    final CSR payload at the shift offs_p."""
    m = counts.shape[0]
    dev = counts.device
    offs = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                      torch.cumsum(counts, 0, dtype=I32)])
    full = counts == sc
    idx = torch.arange(m, dtype=I32, device=dev)
    p = torch.min(torch.where(full, idx, m))
    q = torch.max(torch.where(full, idx, -1)) + 1
    nfull = torch.sum(full, dtype=I32)
    run_ok = (nfull > 0) & (nfull == q - p)
    offs_p = torch.take(offs, torch.clamp(p, 0, m).long())
    meta = torch.stack([offs[-1], torch.max(counts), p, q,
                        run_ok.to(I32), offs_p]).to(I32)
    return offs, meta


def dia_scatter_emit(cvT, present, row_offsets, c_cols, c_vals, *,
                     base_c: int):
    """Per-row DIA emission into the shared C (in place; the buffers'
    last slot takes the dropped writes), straight from the uncompacted
    (m, sc) planes: each present entry goes to row_offsets[r] + rank.
    Rows of other routes have no presence here and write nothing."""
    m, sc = cvT.shape
    dev = cvT.device
    e = torch.arange(sc, dtype=I32, device=dev)[None, :]
    i = torch.arange(m, dtype=I32, device=dev)[:, None]
    rank = torch.cumsum(present, dim=1, dtype=I32) - 1
    flat = torch.where(present, row_offsets[:-1][:, None] + rank,
                       c_cols.shape[0] - 1).reshape(-1)
    c_cols[flat] = (i + base_c + e).to(I32).reshape(-1)
    c_vals[flat] = cvT.reshape(-1).to(c_vals.dtype)
    return c_cols, c_vals


def dia_emit_edge(cols_s, vals_s, row_offsets, *, sc: int, r0: int, r1: int,
                  o0: int, n_out: int):
    """Gather of outputs [o0, o0 + n_out) covering staged rows [r0, r1):
    the non-uniform edge rows of a uniform-emit plan."""
    i = torch.arange(n_out, dtype=I32, device=cols_s.device)
    rid = r0 + _count_le(row_offsets[r0 + 1: r1], i + o0)
    src = rid * sc + (i + o0 - row_offsets[rid])
    src = torch.clamp(src, 0, cols_s.numel() - 1)
    return cols_s.reshape(-1)[src], vals_s.reshape(-1)[src]
