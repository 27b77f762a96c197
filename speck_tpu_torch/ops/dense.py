"""The dense-tile eligibility statistics and the gather emission of
row-staged output planes (torch port of ``speck_tpu/ops/dense.py``'s
``tile_stats`` and ``dense_gather_emit``; the dense-tile route itself is
not ported yet).

``tile_stats`` feeds the planning pass's dense-tile gate
(``stream.plan_device_stream``), which counts the eligible tiles on the
device, so that the planner raises for the dense tiles only where the
reference would take them. The DIA route emits with ``dense_gather_emit``
when its uniform fast path is not taken.
"""

from __future__ import annotations

import torch

from .stream import INT_MAX, _count_le

I32 = torch.int32
INT_MIN = -INT_MAX - 1


def _segment_reduce(vals, seg, m: int, reduce: str):
    """Per-row min or max of per-nonzero ``vals`` (``seg`` their rows);
    empty rows keep JAX's segment identity (the int32 max for a min, the
    int32 min for a max)."""
    init = INT_MAX if reduce == "amin" else INT_MIN
    out = torch.full((m,), init, dtype=I32, device=vals.device)
    return out.scatter_reduce_(0, seg.long(), vals.to(I32), reduce,
                               include_self=False)


def _row_ends(indptr, indices):
    """Each row's length and its first and last column, which bound a
    canonical row's columns; an empty row gives (0, INT_MAX, -1)."""
    length = indptr[1:] - indptr[:-1]
    # the JAX gathers clamp an index past the end, so do these
    hi = indices.shape[0] - 1
    first = indices[torch.clamp(indptr[:-1], 0, hi)]
    last = indices[torch.clamp(indptr[1:] - 1, 0, hi)]
    nonempty = length > 0
    return (length, torch.where(nonempty, first, INT_MAX),
            torch.where(nonempty, last, -1))


def tile_stats(a_indptr, a_indices, b_indptr, b_indices, row_ops, a_len, *,
               tile_rows: int, m: int):
    """Per-tile dense-eligibility statistics on the device, as one stacked
    (6, T) int32 array [kmin, kspan, cmin, cspan, amax, bmax]
    (T = ceil(m / tile_rows)): the A-column window base and span, the
    output-column window base and span, the longest A row and the longest
    referenced B row of each tile of ``tile_rows`` consecutive rows.
    Padding rows past m are empty; an empty tile has span 0."""
    dev = a_indptr.device
    T = -(-m // tile_rows)
    mpad = T * tile_rows
    nnz = a_indices.shape[0]
    # a row's k range (A) and output range (B)
    _, a_kmin, a_kmax = _row_ends(a_indptr, a_indices)
    b_len, b_cmin, b_cmax = _row_ends(b_indptr, b_indices)

    # per-A-row output range and longest referenced B row: segment min/max
    # over A's nonzeros, each nonzero's row by a binary search over the row
    # ends (empty rows repeat an index of indptr, so no scatter there)
    seg = _count_le(a_indptr[1:], torch.arange(nnz, dtype=I32, device=dev))
    gcmin = _segment_reduce(b_cmin[a_indices], seg, m, "amin")
    gcmax = _segment_reduce(b_cmax[a_indices], seg, m, "amax")
    gblen = _segment_reduce(b_len[a_indices], seg, m, "amax")
    no_ops = row_ops <= 0
    gcmin = torch.where(no_ops, INT_MAX, gcmin)
    gcmax = torch.where(no_ops, -1, gcmax)
    gblen = torch.where(no_ops, 0, gblen)

    def tile_reduce(x, red, fill):
        pad = torch.full((mpad - m,), fill, dtype=I32, device=dev)
        return red(torch.cat([x.to(I32), pad]).reshape(T, tile_rows), dim=1)

    kmin = tile_reduce(a_kmin, torch.amin, INT_MAX)
    kmax = tile_reduce(a_kmax, torch.amax, -1)
    cmin = tile_reduce(gcmin, torch.amin, INT_MAX)
    cmax = tile_reduce(gcmax, torch.amax, -1)
    amax = tile_reduce(a_len, torch.amax, 0)
    bmax = tile_reduce(gblen, torch.amax, 0)
    kspan = torch.where(kmax < 0, 0, kmax - kmin + 1)
    cspan = torch.where(cmax < 0, 0, cmax - cmin + 1)
    kmin = torch.where(kmax < 0, 0, kmin)
    cmin = torch.where(cmax < 0, 0, cmin)
    return torch.stack([kmin, kspan, cmin, cspan, amax, bmax]).to(I32)


def dense_gather_emit(cols_c, vals_c, row_offsets, *, tile_rows: int,
                      cw: int, m: int, nnz: int = 0):
    """The final CSR arrays by gather from staged planes that cover rows
    0..m in order, so output row r's staged slots live at flat index
    r * cw + o. One read per output: the per-row term r * cw -
    row_offsets[r] is constant over a row's output segment; the reference
    seeds it at each live row's start and forward-fills it, here each
    output looks its row up by a binary search over the row ends.
    ``tile_rows`` and ``m`` are the reference's static arguments (the
    layout rule above holds for any tile height)."""
    total = nnz if nnz else 1
    i = torch.arange(total, dtype=I32, device=cols_c.device)
    n_rows = row_offsets.shape[0] - 1
    r = torch.clamp(_count_le(row_offsets[1:], i), 0, n_rows - 1)
    src = torch.clamp(r * cw - row_offsets[r] + i, 0, cols_c.numel() - 1)
    return cols_c.reshape(-1)[src], vals_c.reshape(-1)[src]
