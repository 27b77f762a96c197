"""Expand-sort-contract in the uniform-cap (rows, cap) rectangle, direct-copy
rows and the packed B record: the port of ``speck_tpu/ops/esc.py``.

``esc_fixed`` is the one-shot count and numeric pass over all rows at one
capacity, with no host decisions: expand each row's products into a
(m, cap) rectangle (``_expand``, whose owner lookup ``_owner_fill`` is a
key sort and a doubling forward fill), sort each row by column, contract
equal-column runs (``_contract``: kernel K3, ``contract.contract_runs``)
and move the run totals to the front (``_compact_by_rank``). Every row sort
is kernel K2 (``bitonic.row_sort``, a stable radix sort: equal keys keep
their slot order, as in the JAX sorts), which takes any width, so any
``cap`` works.
``direct_chunk`` fills single-A-nonzero rows: C row = valA * B row, already
sorted, a gather plus a masked scatter with no expansion or sort.
``pack_csr_arrays`` interleaves (col id, value bits) into one (nnz, 2)
int32 record, so each product's B read is one 8-byte gather.

``esc_fixed`` takes float16, bfloat16, float32 and float64 values, mixed
too, as the reference's dtype-generic form does: the products promote
(bfloat16 times float32 is float32) and C takes their type. K2 carries
32-bit payloads, so a 16-bit or float64 plane moves by its sorted slot
(``bitonic.slot_payload``), the owner fill carries each product's A index
instead of its value bits, and K3 runs its ``__half``, ``__nv_bfloat16``
or ``double`` variant.
"""

from __future__ import annotations

import torch

from . import bitonic
from .contract import VALUE_DTYPES, contract_runs
from .contract import run_boundaries as _run_boundaries  # noqa: F401
from .contract import run_sums as _run_sums  # noqa: F401


def pack_csr_arrays(indices: torch.Tensor, data: torch.Tensor
                    ) -> torch.Tensor:
    """(nnz, 2) int32 record of (col id, float32 value bits). Other value
    types raise TypeError, where the reference's bitcast to int32 raises
    (the dense tiles' B of a float32 A, the mesh stream's 16-bit B)."""
    if data.dtype.itemsize != 4:
        raise TypeError(f"the packed record holds 32-bit values, not "
                        f"{data.dtype} (speck_tpu raises here too)")
    return torch.stack([indices.to(torch.int32),
                        data.contiguous().view(torch.int32)], dim=-1)


def packable(data) -> bool:
    return data.dtype.itemsize == 4


def direct_chunk(rows_padded, start: int, valid: int, a_indptr, a_indices,
                 a_data, b_indptr, b_indices, b_data, row_offsets, c_cols,
                 c_vals, *, chunk_rows: int, cap: int):
    """Numeric fill of sorted rows [start, start + valid) of
    ``rows_padded``, each a single A nonzero times one (canonical) B row
    of at most ``cap`` entries, into C's padded output buffers in place
    (their last slot takes the dropped writes)."""
    dev = rows_padded.device
    rows = rows_padded[start: start + chunk_rows]
    valid_rows = torch.arange(chunk_rows, dtype=torch.int32,
                              device=dev) < valid
    r = torch.where(valid_rows, rows, 0)
    p = a_indptr[r]
    acol = a_indices[p]
    aval = a_data[p]
    b0 = b_indptr[acol]
    blen = b_indptr[acol + 1] - b0
    t = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    valid_t = (t < blen[:, None]) & valid_rows[:, None]
    src = torch.where(valid_t, b0[:, None] + t, 0)
    oob = c_cols.shape[0] - 1
    flat = torch.where(valid_t, row_offsets[r][:, None] + t, oob)
    c_cols.index_put_((flat,), b_indices[src])
    c_vals.index_put_((flat,), (aval[:, None] * b_data[src]).to(c_vals.dtype))
    return c_cols, c_vals


def _sort_rows(key, payloads):
    """Each row of ``key`` sorted ascending and stably, ``payloads``
    permuted alike, through K2 (which pads a width that is not a power of
    two with ``INT32_MAX`` keys and cuts the pad off)."""
    return bitonic.row_sort(key.contiguous(),
                            [p.contiguous() for p in payloads])


def _take(x, idx):
    """x[idx], or zeros when x is empty (the JAX gathers clamp; every
    index here is masked where it would read an empty array)."""
    if x.numel() == 0:
        return torch.zeros(idx.shape, dtype=x.dtype, device=idx.device)
    return x[idx]


def _owner_fill(live, e, chans, cap: int):
    """Owner payloads for every product slot, by one key sort, a doubling
    forward fill and one rank sort.

    Each live A slot owns product positions t in [e, e + blen). A-slot
    records (key 2e, unique among live slots) interleave with product
    slots (key 2t+1); after the key sort every product's owner is the
    nearest even-key record to its left, and a last-non-null forward fill
    (Hillis-Steele doubling over the parity mask) carries the owner's
    channels onto its products. The rank sort (product key t, the rest past
    the end) restores product order.

    live: (R, cap) bool; e: (R, cap) int32 start positions (valid where
    live); chans: (R, cap) 32-bit payload channels. Returns the channels by
    product slot t (garbage past a row's last product; callers mask with
    t < ops).
    """
    R = live.shape[0]
    dev = live.device
    t2 = torch.arange(cap, dtype=torch.int32, device=dev)[None, :] * 2 + 1
    key = torch.cat([torch.where(live, 2 * e, 2 * cap + 1).to(torch.int32),
                     t2.expand(R, cap)], dim=1)
    key_s, vals = _sort_rows(
        key, [torch.cat([c, torch.zeros_like(c)], dim=1) for c in chans])
    vals = list(vals)
    is_owner = (key_s & 1) == 0     # even key <=> live A-slot record
    filled = is_owner
    d, W = 1, 2 * cap
    while d < W:
        f_s = torch.cat([torch.zeros((R, d), dtype=torch.bool, device=dev),
                         filled[:, :-d]], dim=1)
        take = ~filled & f_s
        for i, v in enumerate(vals):
            v_s = torch.cat([torch.zeros_like(v[:, :d]), v[:, :-d]], dim=1)
            vals[i] = torch.where(take, v_s, v)
        filled = filled | f_s
        d <<= 1
    key2 = torch.where(is_owner, 2 * cap, key_s >> 1).to(torch.int32)
    _, out = _sort_rows(key2, vals)
    return tuple(o[:, :cap] for o in out)


def _expand(rows, valid_rows, a_indptr, a_indices, a_data, b_start, b_len,
            b_indices, b_data, cap: int, n_cols: int, with_values: bool):
    """The (rows, cap) rectangle of intermediate products.

    B is given by per-row (start, length) arrays, so a gathered or padded B
    layout works unchanged; for a plain CSR, b_start = indptr[:-1] and
    b_len its differences. Each product slot's owning A nonzero comes from
    ``_owner_fill``; its payload u = source base - start makes the source
    index u + t. Zero-length B rows own no products and are left out of the
    fill.

    Returns (col, val, ops): col[r, t] is the B column of product t of row
    r, or the sentinel ``n_cols`` when t >= ops[r]; val is valA * valB (0
    beyond ops, None without values); ops is the product count per row.
    """
    dev = rows.device
    r = torch.where(valid_rows, rows, 0)
    a0 = a_indptr[r]
    alen = torch.where(valid_rows, a_indptr[r + 1] - a0, 0)
    j = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    va = j < alen[:, None]
    aidx = torch.where(va, a0[:, None] + j, 0)
    acol = torch.where(va, _take(a_indices, aidx), 0)
    bstart_a = b_start[acol]
    blen = torch.where(va, b_len[acol], 0)
    cum = torch.cumsum(blen, dim=1).to(torch.int32)   # int64 from cumsum
    ops = cum[:, -1]
    e = cum - blen                                     # slot start positions
    live = va & (blen > 0)
    u = bstart_a - e                                   # src base - start
    if with_values and a_data.dtype.itemsize == 4:
        araw = torch.where(va, _take(a_data, aidx), 0).contiguous().view(
            torch.int32)
        uc, ar = _owner_fill(live, e, (u, araw), cap)
        ac = ar.contiguous().view(torch.float32)
    elif with_values:
        # a 64-bit value does not fit a channel: carry its A index
        uc, ai = _owner_fill(live, e, (u, aidx.to(torch.int32)), cap)
        ac = _take(a_data, torch.clamp(ai, 0, max(a_data.shape[0] - 1, 0)))
    else:
        (uc,) = _owner_fill(live, e, (u,), cap)
    valid_t = j < ops[:, None]
    src = torch.where(valid_t, uc + j, 0)
    col = torch.where(valid_t, _take(b_indices, src), n_cols).to(torch.int32)
    val = (torch.where(valid_t, ac * _take(b_data, src), 0)
           if with_values else None)
    return col, val, ops


def _contract(col_s, val_s, n_cols: int):
    """Run-last mask and per-run sums of a column-sorted rectangle: K3 on
    the card (``contract_runs``), its plain version on the CPU."""
    return contract_runs(col_s.contiguous(), val_s.contiguous(), n_cols)


def _compact_by_rank(last, col_s, run_sum):
    """Run-last (col, sum) pairs moved to the front, order kept: rank keys
    < W for run-lasts, W + t for the rest, then one key sort."""
    W = col_s.shape[1]
    t = torch.arange(W, dtype=torch.int32, device=col_s.device)[None, :]
    rank = torch.cumsum(last.to(torch.int32), dim=1).to(torch.int32) - 1
    key = torch.where(last, rank, W + t).to(torch.int32)
    _, (cols_c, moved) = _sort_rows(key, [col_s,
                                          bitonic.slot_payload(run_sum)])
    return cols_c, bitonic.by_slot(run_sum, moved)


def esc_fixed(a_indptr, a_indices, a_data, b_start, b_len, b_indices, b_data,
              *, cap: int, n_cols: int):
    """One-shot count and numeric SpGEMM over all rows at one capacity.

    Returns (counts (m,), cols (m, cap), vals (m, cap)), int32, int32 and
    the values' dtype: each row's first counts[r] slots hold its
    column-sorted result. Products past ``cap`` in a row are dropped, as in
    the JAX form: ``cap`` must be at least every row's product count and A
    length.
    """
    for x in (a_data, b_data):
        if x.dtype not in VALUE_DTYPES:
            raise TypeError(f"esc_fixed: values must be float16, bfloat16, "
                            f"float32 or float64, not {x.dtype}")
    m = a_indptr.shape[0] - 1
    dev = a_indptr.device
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    valid_rows = torch.ones((m,), dtype=torch.bool, device=dev)
    col, val, _ = _expand(rows, valid_rows, a_indptr, a_indices, a_data,
                          b_start, b_len, b_indices, b_data, cap, n_cols,
                          with_values=True)
    col_s, (moved,) = _sort_rows(col, [bitonic.slot_payload(val)])
    last, run_sum = _contract(col_s, bitonic.by_slot(val, moved), n_cols)
    counts = last.sum(dim=1, dtype=torch.int32)
    cols_c, vals_c = _compact_by_rank(last, col_s, run_sum)
    return counts, cols_c[:, :cap], vals_c[:, :cap]
