"""Dense-window SpGEMM tiles (torch port of ``speck_tpu/ops/dense.py``).

A tile of TR consecutive rows whose A columns span at most KW and whose
output columns span at most CW is one pair of window products:

    C_tile[TR, CW]   = A_dense[TR, KW] @ B_dense[KW, CW]     (values)
    cnt_tile[TR, CW] = A_pat[TR, KW]  @ B_pat[KW, CW]        (presence)

``tile_stats`` gives each tile's windows and the planning pass
(``stream.plan_device_stream``) picks the eligible tiles. ``dense_tiles``
runs a batch of K tiles as one flat problem: ``_gather_rect`` reads each
row's fragment (one packed 8-byte record gather a nonzero in float32),
``_densify_sorted`` (the default) or ``_densify_scatter`` lays it into
its window, ``torch.bmm`` forms the values in full precision (TF32 is
switched off around the call) and a bfloat16 ``bmm`` of the patterns
forms the counts, of which only ``> 0.5`` is read, so presence is exact
and independent of cancellation. A rank sort (kernel K2,
``bitonic.row_sort``) moves each row's present entries to its front in
column order. ``dense_emit`` scatters a batch's staged rows into C;
``dense_gather_emit`` gathers them when the tiles cover every row in
order. K2 pads every width here that is not a power of two with
``INT32_MAX`` keys and cuts the pad off (``bitonic.row_sort``); float64
and 16-bit values move by their sorted slot.

Requires canonical A and B, as the reference does; the planner gates on
it.
"""

from __future__ import annotations

import torch

from .bitonic import by_slot, slot_payload
from .esc import _sort_rows
from .stream import INT_MAX, _count_le

I32 = torch.int32
INT_MIN = -INT_MAX - 1


def _running_max(x, block: int = 1024):
    """Inclusive running max of a 1-D tensor as a two-level scan: each
    row of an (n / block, block) view by ``torch.cummax`` (its CUDA
    kernel scans a row with 16 threads, so a flat 1-D call of 50M
    elements is one slow row), then the rows' carries by the same scan
    one level up."""
    n = x.shape[0]
    if n <= block:
        return torch.cummax(x, 0).values
    nb = -(-n // block)
    low = torch.iinfo(x.dtype).min
    rows = torch.cat([x, x.new_full((nb * block - n,), low)]).reshape(
        nb, block)
    rows = torch.cummax(rows, 1).values
    carry = _running_max(rows[:, -1].contiguous(), block)
    rows[1:] = torch.maximum(rows[1:], carry[:-1, None])
    return rows.reshape(-1)[:n]


def _segment_reduce(vals, seg, indptr, reduce: str):
    """Per-row min or max of per-nonzero int32 ``vals`` (``seg`` their
    rows, ascending: CSR order, row offsets ``indptr``); empty rows keep
    JAX's segment identity (the int32 max for a min, the int32 min for a
    max). One running max over int64 keys seg << 32 | biased value
    (``_running_max``): a row's keys exceed every earlier row's, so the
    running max at a row's last nonzero is its own. No atomics:
    ``scatter_reduce_`` serializes equal targets (15 ms a call over the
    bench giant row's 50M nonzeros on the H100)."""
    m = indptr.shape[0] - 1
    init = INT_MAX if reduce == "amin" else INT_MIN
    nnz = vals.shape[0]
    if nnz == 0:
        return torch.full((m,), init, dtype=I32, device=vals.device)
    v = vals.to(torch.int64)
    # the biased value is in [0, 2^32) and orders as the reduction wants
    biased = (2 ** 31 - 1 - v) if reduce == "amin" else (v + 2 ** 31)
    run = _running_max((seg.to(torch.int64) << 32) | biased)
    low = run[torch.clamp(indptr[1:] - 1, 0, nnz - 1)] & (2 ** 32 - 1)
    got = (2 ** 31 - 1 - low) if reduce == "amin" else (low - 2 ** 31)
    return torch.where(indptr[1:] > indptr[:-1], got, init).to(I32)


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
    gcmin = _segment_reduce(b_cmin[a_indices], seg, a_indptr, "amin")
    gcmax = _segment_reduce(b_cmax[a_indices], seg, a_indptr, "amax")
    gblen = _segment_reduce(b_len[a_indices], seg, a_indptr, "amax")
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


def _gather_rect(indptr, indices, data, rows, valid, width: int,
                 packed=None):
    """(R, width) rectangle of a CSR fragment: column ids, values and the
    live mask of rows ``rows`` (``valid`` False gives an empty row). With
    ``packed`` ((nnz, 2) int32 records of column and float32 value bits,
    ``esc.pack_csr_arrays``) each element is one 8-byte record gather."""
    r = torch.where(valid, rows, 0)
    p0 = indptr[r]
    ln = torch.where(valid, indptr[r + 1] - p0, 0)
    j = torch.arange(width, dtype=I32, device=rows.device)[None, :]
    live = j < ln[:, None]
    idx = torch.where(live, p0[:, None] + j, 0)
    if packed is not None:
        rec = packed[idx]
        cols = torch.where(live, rec[..., 0], 0)
        vals = torch.where(live, rec[..., 1].contiguous().view(torch.float32),
                           0.0)
        return cols, vals, live
    cols = torch.where(live, indices[idx], 0)
    vals = torch.where(live, data[idx], 0.0) if data is not None else None
    return cols, vals, live


def _densify_scatter(loc, val, width: int):
    """dense[r, loc[r, l]] = val[r, l] by one unique-index scatter a plane;
    slots outside [0, width) go to a trailing drop slot. Returns (dense,
    hit)."""
    R, L = loc.shape
    dev = loc.device
    r = torch.arange(R, dtype=I32, device=dev)[:, None]
    inside = (loc >= 0) & (loc < width)
    flat = torch.where(inside, r * width + loc, R * width)
    dense = torch.zeros(R * width + 1, dtype=val.dtype, device=dev)
    dense.index_put_((flat,), val)
    hit = torch.zeros(R * width + 1, dtype=torch.bool, device=dev)
    hit.index_put_((flat,), inside)
    return (dense[:R * width].reshape(R, width),
            hit[:R * width].reshape(R, width))


def _densify_sorted(loc, val, width: int):
    """Densification of per-row sorted fragments by two row sorts (K2).

    loc: (R, L) ascending per row, unique within a row (pads hold a value
    >= width); val: (R, L). Returns (dense (R, width), hit (R, width)
    bool) with dense[r, loc[r, l]] = val[r, l].

    The L entries join ``width`` background slots, one per column, and
    sort by col * 2 + is_background: each background's left neighbour is
    its entry when there is one. A rank sort then moves the backgrounds,
    already in column order, to the front."""
    R, L = loc.shape
    W = width
    dev = loc.device
    kcol = torch.arange(W, dtype=I32, device=dev)[None, :].expand(R, W)
    key1 = torch.cat([loc * 2, kcol * 2 + 1], dim=1).to(I32)
    vals = torch.cat([val, torch.zeros((R, W), dtype=val.dtype, device=dev)],
                     dim=1)
    key1, (moved,) = _sort_rows(key1, [slot_payload(vals)])
    vals = by_slot(vals, moved)

    is_bg = (key1 & 1) == 1
    col = key1 >> 1
    prev_col = torch.cat([torch.full((R, 1), -1, dtype=I32, device=dev),
                          col[:, :-1]], dim=1)
    prev_bg = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=dev),
                         is_bg[:, :-1]], dim=1)
    prev_val = torch.cat([torch.zeros((R, 1), dtype=vals.dtype, device=dev),
                          vals[:, :-1]], dim=1)
    matched = is_bg & ~prev_bg & (prev_col == col)
    key2 = torch.where(is_bg, col, 2 * W + L).to(I32)
    out_val = torch.where(matched, prev_val, 0.0)
    _, (moved2, hit) = _sort_rows(key2, [slot_payload(out_val),
                                         matched.to(I32)])
    dense = by_slot(out_val, moved2)
    return dense[:, :W], hit[:, :W] > 0


def _full_precision_bmm(a, b):
    """``torch.bmm`` with TF32 off whatever the process set: the
    counterpart of the reference's ``Precision.HIGHEST``. Mixed value
    types multiply in their promoted type, as the reference's einsum
    does (bfloat16 times float32 is float32); 16-bit products accumulate
    in float32 and round once."""
    dt = torch.promote_types(a.dtype, b.dtype)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.bmm(a.to(dt), b.to(dt))
    finally:
        torch.set_float32_matmul_precision(prev)


def tile_gather_a(r0s, a_indptr, a_indices, a_data, a_packed=None, *,
                  tile_rows: int, la: int, m: int):
    """The K tiles' A rows r0 + [0, TR) as one flat (K * TR) batch and
    their (K * TR, la) rectangle: (rows, rows < m, (col, val, live))."""
    t_tr = torch.arange(tile_rows, dtype=I32, device=r0s.device)[None, :]
    rows = (r0s[:, None] + t_tr).reshape(-1)
    vrow = rows < m
    return rows, vrow, _gather_rect(
        a_indptr, a_indices, a_data, torch.clamp(rows, max=m - 1), vrow, la,
        packed=a_packed)


def tile_gather_b(kbases, b_indptr, b_indices, b_data, b_packed=None, *,
                  kw: int, lb: int, k_dim: int):
    """The K tiles' B rows kbase + [0, kw) as one flat (K * kw) batch: their
    (K * kw, lb) rectangle (col, val, live)."""
    ks = (kbases[:, None]
          + torch.arange(kw, dtype=I32, device=kbases.device)[None, :]
          ).reshape(-1)
    return _gather_rect(b_indptr, b_indices, b_data,
                        torch.clamp(ks, max=k_dim - 1), ks < k_dim, lb,
                        packed=b_packed)


def tile_densify(col, val, live, bases, rep: int, width: int,
                 densify: str = "sort"):
    """A rectangle into its windows: each row's columns made local to its
    tile's base (``rep`` rows a tile), dead entries at ``width``, then
    densified (dense values, hit pattern)."""
    loc = torch.where(live, col - bases.repeat_interleave(rep)[:, None],
                      width).to(I32)
    dens = _densify_scatter if densify == "scatter" else _densify_sorted
    return dens(loc, val, width)


def tile_products(A_dense, A_hit, B_dense, B_hit, *, tile_rows: int, kw: int,
                  cw: int):
    """The window products as one batched ``bmm`` each: values at full
    precision and the bfloat16 pattern count, both (K * TR, cw)."""
    K = A_dense.shape[0] // tile_rows
    C_vals = _full_precision_bmm(
        A_dense.reshape(K, tile_rows, kw), B_dense.reshape(K, kw, cw)
    ).reshape(K * tile_rows, cw)
    C_cnt = torch.bmm(
        A_hit.reshape(K, tile_rows, kw).to(torch.bfloat16),
        B_hit.reshape(K, kw, cw).to(torch.bfloat16)).reshape(K * tile_rows,
                                                             cw)
    return C_vals, C_cnt


def tile_compact(C_vals, C_cnt, vrow, cbases, *, tile_rows: int, cw: int,
                 n_cols: int):
    """The rank compaction (one K2 sort): each tile row's present entries
    to its front in column order. Returns (counts (K, TR), cols (K, TR,
    cw), vals (K, TR, cw))."""
    K = C_vals.shape[0] // tile_rows
    t_cw = torch.arange(cw, dtype=I32, device=C_vals.device)[None, :]
    cb_row = cbases.repeat_interleave(tile_rows)
    present = ((C_cnt > 0.5) & vrow[:, None]
               & ((cb_row[:, None] + t_cw) < n_cols))
    counts = torch.sum(present, dim=1, dtype=I32)
    rank = torch.cumsum(present, 1, dtype=I32) - 1
    key = torch.where(present, rank, cw + t_cw).to(I32)
    cols_g = torch.where(present, cb_row[:, None] + t_cw, n_cols).to(I32)
    _, (cols_c, moved) = _sort_rows(key, [cols_g, slot_payload(C_vals)])
    vals_c = by_slot(C_vals, moved)
    return (counts.reshape(K, tile_rows), cols_c.reshape(K, tile_rows, cw),
            vals_c.reshape(K, tile_rows, cw))


def dense_tiles(r0s, kbases, cbases, a_indptr, a_indices, a_data, b_indptr,
                b_indices, b_data, nnz_row, a_packed=None, b_packed=None, *,
                tile_rows: int, kw: int, cw: int, la: int, lb: int, m: int,
                k_dim: int, n_cols: int, densify: str = "sort"):
    """Counting and values of K dense tiles as one flat batch: the K * TR
    rows gather and densify together, the window products run as one
    batched ``bmm`` each, the compaction is one (K * TR, pow2(cw)) K2
    sort. Memory is about K * (TR * kw + kw * cw + 4 * TR * cw) values.

    Padding tiles (r0 >= m) contribute nothing. Sets each tile row's
    count in ``nnz_row`` (padded by one drop slot, in place) and returns
    (nnz_row, (counts (K, TR), cols (K, TR, cw), vals (K, TR, cw))), the
    staged layout ``dense_emit`` consumes."""
    rows, vrow, (acol, aval, alive) = tile_gather_a(
        r0s, a_indptr, a_indices, a_data, a_packed, tile_rows=tile_rows,
        la=la, m=m)
    A_dense, A_hit = tile_densify(acol, aval, alive, kbases, tile_rows, kw,
                                  densify)
    bcol, bval, blive = tile_gather_b(kbases, b_indptr, b_indices, b_data,
                                      b_packed, kw=kw, lb=lb, k_dim=k_dim)
    B_dense, B_hit = tile_densify(bcol, bval, blive, cbases, kw, cw, densify)
    C_vals, C_cnt = tile_products(A_dense, A_hit, B_dense, B_hit,
                                  tile_rows=tile_rows, kw=kw, cw=cw)
    staged = tile_compact(C_vals, C_cnt, vrow, cbases, tile_rows=tile_rows,
                          cw=cw, n_cols=n_cols)
    nnz_row.index_put_((torch.where(vrow, rows, m),), staged[0].reshape(-1))
    return nnz_row, staged


def dense_emit(r0s, counts, cols_c, vals_c, row_offsets, c_cols, c_vals, *,
               tile_rows: int, cw: int, m: int, emit_cap: int = 0):
    """Scatter one dense batch's staged rows into C's padded buffers (in
    place; their last slot takes the dropped writes). ``emit_cap`` (0 =
    cw) trims the scatter to the widest output row."""
    ec = min(cw, emit_cap) if emit_cap else cw
    dev = r0s.device
    rows = (r0s[:, None] + torch.arange(tile_rows, dtype=I32, device=dev)
            [None, :]).reshape(-1)
    vrow = rows < m
    cnt = counts.reshape(-1)
    t = torch.arange(ec, dtype=I32, device=dev)[None, :]
    live = (t < cnt[:, None]) & vrow[:, None]
    base = row_offsets[torch.where(vrow, rows, 0)]
    flat = torch.where(live, base[:, None] + t, c_cols.shape[0] - 1)
    c_cols.index_put_((flat,), cols_c.reshape(-1, cw)[:, :ec])
    c_vals.index_put_((flat,), vals_c.reshape(-1, cw)[:, :ec].to(
        c_vals.dtype))
    return c_cols, c_vals


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
