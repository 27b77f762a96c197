"""The flat product stream (torch port of ``speck_tpu/ops/stream.py``).

Every intermediate product of C = A @ B gets one slot in a flat stream,
tight-packed by the planner: rows sorted by descending product count, wide
rows (more products than the rectangle width W) on whole W-aligned
rectangle rows, contained rows back to back without straddling a
rectangle-row boundary. The stream is cut into (G, W) chunks, and every
chunk of one product space (the stream's, the accumulator region's, a
mesh shard's) reads one bundle of records (``ChunkRecords``). Per chunk,
the first three stages are one step (``chunk_sorted``):

  expand    each slot's row and A-slot record, one packed B-record
            gather per product (kernel K4, ops/expand.stream_expand);
  sort      each rectangle row by the packed key rid_local << pack_bits |
            col, dead slots last (kernel K2, ops/bitonic.row_sort, a
            stable radix sort);
  contract  run-last mask and segmented run sums (kernel K1,
            ops/contract.stream_contract);
  count     exact nnz of every contained row by an O(m) segment
            difference;
  compact   one rank sort (K2) moves run-last entries to the row front.

Wide rows are finished by merge levels (F adjacent segments re-sorted and
contracted at F times the width) and a single wide finish at each row's
deduplicated entry width; emission gathers contained rows from the
concatenated staged chunks and scatters the rest.

With the accumulator on (``use_accum``), a row of many products whose
output columns span a bounded window is planned into a product space of
its own (sorted first, e = -1 in the stream): its chunks expand as the
stream's do and scatter-add into a dense span window
(``stream_chunk_accum``), and ``accum_finalize`` compacts the present
columns (K2).

Port conventions: int32 everywhere; every scatter that the reference
writes with ``mode="drop"`` targets a buffer with one extra trailing slot
that takes the dropped writes (``_drop_buf``), because torch raises on
out-of-range indices and wraps negative ones. The reference's run-length
decodes (boundary scatter-adds + cumsum) and forward fills are binary
searches over the sorted boundary arrays here (``torch.searchsorted``;
the expand's, on the card, K4's own searches): the same values, without
the scatter-adds that torch serializes on repeated indices.

The reference's four A/B knobs (``SpgemmConfig.stream_*``) all run:

  stream_expand_impl   "fill" (default) and "decode": the reference's two
                       forms of one function (each slot's A-slot record
                       and product), so every name runs the one expand,
                       K4 on the card (ops/expand.py);
  stream_compact_impl  "sort" (default): one K2 rank sort; "scatter":
                       three flat scatters to g * W + rank (unique
                       targets, so deterministic), dead slots filled with
                       (INT_MAX, INT_MAX, 0);
  stream_sort_impl     "auto", "xla", "blocked", "bitonic",
                       "bitonic_pallas": every one computes the same
                       function (rows sorted by key), so every name runs
                       the one sort, K2 on the card (a stable radix sort,
                       the port of both bitonic.bitonic_sort_pairs_pallas
                       and blocked_sort_pairs) and the plain stable sort
                       on the CPU;
  stream_level_factor  any F >= 2: merge levels at F * W_in, which K2
                       sorts padded to a power of two where F is not one.

Values: float32 takes the packed (col, value bits) B record. float64 and
the 16-bit types take the reference's unpacked form: the expand gathers
B's columns and values apart and A's value through the A-source map that
rides the record channel (``expand.Unpacked``); products promote as in the
reference (bfloat16 times float32 is float32). K2 carries 32-bit payloads,
so every sort moves a non-32-bit plane by its sorted slot: the slot index
rides as the payload and the values are gathered after the sort
(``bitonic.by_slot``). When the packed key would overflow int32
(``pack_bits == 0``), the chunk sort is two stable K2 passes, by column and
then by row.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.config import ProductOverflow
from .analysis import _count_le, _decode, cumsum1d
from .bitonic import by_slot, row_sort, slot_payload
from .contract import stream_contract
from .expand import stream_expand

INT_MAX = 2 ** 31 - 1
I32 = torch.int32

# power-of-two class ladder: q class k has q = 1 << k
N_QCLASS = 32
# wide-row segment counts shipped in the planning pack
N_WSEG_PACK = 512

# the reference's accepted values of the A/B knobs (the first is the
# default)
SORT_IMPLS = ("auto", "xla", "blocked", "bitonic", "bitonic_pallas")
COMPACT_IMPLS = ("sort", "scatter")
EXPAND_IMPLS = ("fill", "decode")


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _drop_buf(n: int, fill, dtype, device) -> torch.Tensor:
    """A fill-valued buffer of n slots plus one trailing drop slot."""
    return torch.full((n + 1,), fill, dtype=dtype, device=device)


def _run_start(key: torch.Tensor) -> torch.Tensor:
    """Per (R, W) slot, the column where its run of equal ``key`` starts
    (key non-decreasing along each row): the reference's forward fill of
    run-start positions."""
    key = key.contiguous()
    return torch.searchsorted(key, key, out_int32=True)


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort by several keys, most significant first (stable
    sorts from the least significant key up), as int32."""
    perm = None
    for k in reversed(keys):
        kk = k if perm is None else k[perm]
        p = torch.sort(kk, stable=True).indices
        perm = p if perm is None else perm[p]
    return perm.to(I32)


def _plan_rows_impl(row_ops, stream_mask, direct_mask, *, min_q: int, m: int,
                    w0: int = 8192, w_cap: int = 65536,
                    w_fixed: Optional[int] = None, accum_mask=None,
                    span=None):
    """Row-level half of the stream planning (the tight layout): sort,
    stream offsets, live prefixes, class histograms, all O(m).

    With ``accum_mask`` and ``span`` the accumulator rows form a fourth
    region, sorted first by descending span class: their own tight product
    space (e2, q2) and the sentinel e = -1 in the main stream, which the
    decodes count and no chunk expands.

    Returns (rows_sorted, e, q_sorted, el, ops_sorted, hist_pack,
    tight_pack, e2, q2_sorted): hist_pack (4 * N_QCLASS,) = [stream
    q-class hist | direct class hist | accumulator span-class hist | its
    product sums]; tight_pack (4 + N_WSEG_PACK,) = [W, total_q, n_wide,
    r_wide, wide_segs...]."""
    dev = row_ops.device
    ops = torch.clamp(row_ops, min=0)
    # exact integer ceil(log2): count powers of two below ops
    pows = torch.ones(31, dtype=I32, device=dev) << _arange(31, dev)
    clog2 = torch.sum(ops[:, None] > pows[None, :], dim=1, dtype=I32)
    qc = torch.clamp(clog2, min=int(np.log2(min_q)))
    if accum_mask is None:
        accum_mask = torch.zeros(m, dtype=torch.bool, device=dev)
        span = torch.ones(m, dtype=I32, device=dev)
    sp = torch.clamp(span, min=1)
    sc = torch.sum(sp[:, None] > pows[None, :], dim=1, dtype=I32)
    qc = torch.where(stream_mask, qc, 0)
    dc = torch.where(direct_mask, clog2, 0)
    sc = torch.where(accum_mask, sc, 0)

    # sort key: region (0 accumulator / 1 stream / 2 direct / 3 rest),
    # descending class, then descending ops; stable, so ties keep row order
    region = torch.where(accum_mask, 0, torch.where(
        stream_mask, 1, torch.where(direct_mask, 2, 3)))
    subkey = torch.where(accum_mask, N_QCLASS - 1 - sc, torch.where(
        stream_mask, N_QCLASS - 1 - qc,
        torch.where(direct_mask, N_QCLASS - 1 - dc, 0)))
    key = (region * (2 * N_QCLASS) + subkey).to(I32)
    rows_sorted = _stable_order(key, -ops)

    def class_hist(cls, x):
        return torch.zeros(N_QCLASS, dtype=I32, device=dev).index_add_(
            0, cls, x.to(I32))

    s_hist = class_hist(qc, stream_mask)
    d_hist = class_hist(dc, direct_mask)
    a_hist = class_hist(sc, accum_mask)
    a_psum = class_hist(sc, torch.where(accum_mask, ops, 0))
    hist_pack = torch.cat([s_hist, d_hist, a_hist, a_psum])
    return _tight_layout(rows_sorted, ops, qc, stream_mask, accum_mask,
                         s_hist, hist_pack, min_q=min_q, m=m, w0=w0,
                         w_cap=w_cap, w_fixed=w_fixed)


def _tight_layout(rows1, ops, qc, stream_mask, accum_mask, s_hist,
                  hist_pack, *, min_q: int, m: int, w0: int,
                  w_cap: int = 65536, w_fixed: Optional[int] = None):
    """Tight stream placement: exact wide segments, back-to-back contained
    rows, three relocation rounds for rows that would straddle a W
    boundary, a pow2-aligned tail, then a stable sort by final start; the
    accumulator rows (first) get e = -1 and their own packed product
    space. ``tight_total_host`` is the numpy twin of the total."""
    dev = ops.device
    if w_fixed is not None:
        W = torch.full((), w_fixed, dtype=I32, device=dev)
    else:
        # adaptive rectangle width from the q-class histogram
        cls = _arange(N_QCLASS, dev)
        maxcls = torch.max(torch.where(s_hist > 0, cls, -1))
        W = torch.clamp(
            torch.ones((), dtype=I32, device=dev)
            << torch.clamp(maxcls - 10, 0, 16), min=w0).clamp(
                max=max(w0, w_cap)).to(I32)

    ops1 = ops[rows1]
    stream1 = stream_mask[rows1]
    accum1 = accum_mask[rows1]
    wide1 = stream1 & (ops1 > W)
    segs1 = torch.where(wide1, (ops1 + W - 1) // W, 0)
    # mid-size contained rows (q > W/8) take their pow2 quantum upfront
    qe1 = torch.clamp(ops1, min=min_q)
    qp1 = torch.ones_like(ops1) << qc[rows1]
    q1 = torch.where(wide1, segs1 * W,
                     torch.where(stream1,
                                 torch.where(qe1 > W // 8, qp1, qe1), 0))
    c = cumsum1d(q1)
    e_try = c - q1
    strad = stream1 & ~wide1 & ((e_try // W) != ((e_try + q1 - 1) // W))
    e_f1 = torch.where(stream1 & ~strad, e_try, 0)
    total_q = c[-1]
    base = ((total_q + W - 1) // W) * W
    pend = strad
    for _ in range(2):
        alloc = torch.where(pend, q1, 0)
        c = cumsum1d(alloc)
        e_try = base + c - alloc
        strad = pend & ((e_try // W) != ((e_try + q1 - 1) // W))
        e_f1 = torch.where(pend & ~strad, e_try, e_f1)
        placed = c[-1] > 0
        total_q = torch.where(placed, base + c[-1], total_q)
        base = torch.where(placed, ((base + c[-1] + W - 1) // W) * W, base)
        pend = strad
    # final tail: pow2 allocations from a W-aligned base
    qs2 = torch.where(pend, torch.ones_like(ops1) << qc[rows1], 0)
    c2 = cumsum1d(qs2)
    e_f1 = torch.where(pend, base + c2 - qs2, e_f1)
    total_q = torch.where(c2[-1] > 0, base + c2[-1], total_q)
    q_f1 = torch.where(pend, qs2, q1)
    e_f1 = torch.where(stream1, e_f1,
                       torch.where(accum1, -1, total_q)).to(I32)
    # the accumulator product space: the accumulator prefix of the first
    # order is final, every other row carries the constant total
    q2_1 = torch.where(accum1, ops1, 0)
    e2_1 = cumsum1d(q2_1) - q2_1

    # restore ascending-e order (stable: the -1s and the total_q tail keep
    # their region order)
    pi = _stable_order(e_f1)
    rows_sorted = rows1[pi]
    e = e_f1[pi]
    q_sorted = q_f1[pi]
    ops_sorted = torch.where(stream1, ops1, 0)[pi]
    el = cumsum1d(ops_sorted) - ops_sorted
    e2 = e2_1[pi].to(I32)
    q2_sorted = q2_1[pi].to(I32)

    # the wide rows' segment counts, at sorted positions from n_accum on
    n_wide = torch.sum(wide1, dtype=I32)
    r_wide = torch.sum(segs1, dtype=I32)
    n_accum = torch.sum(accum1, dtype=I32)
    k_idx = _arange(N_WSEG_PACK, dev)
    wwin = torch.cat([ops_sorted,
                      torch.zeros(N_WSEG_PACK, dtype=I32, device=dev)]
                     )[n_accum + k_idx]
    wsegs = torch.where(k_idx < n_wide, (wwin + W - 1) // W, 0)
    tight_pack = torch.cat([torch.stack([W, total_q, n_wide, r_wide]).to(I32),
                            wsegs.to(I32)])
    return (rows_sorted, e, q_sorted, el, ops_sorted, hist_pack, tight_pack,
            e2, q2_sorted)


def tight_total_host(row_ops: np.ndarray, W: int, min_q: int) -> int:
    """Exact numpy twin of _tight_layout's stream total."""
    ops = np.asarray(row_ops, np.int64)
    ops = np.sort(ops[ops > 0])[::-1]
    if ops.size == 0:
        return 0
    wide = ops > W
    qe = np.maximum(ops, min_q)
    q = np.where(wide, -(-ops // W) * W,
                 np.where(qe > W // 8, _pow2ceil_arr(qe), qe))
    c = np.cumsum(q)
    e_try = c - q
    strad = ~wide & ((e_try // W) != ((e_try + q - 1) // W))
    total_q = int(c[-1])
    base = -(-total_q // W) * W
    pend = strad
    for _ in range(2):
        alloc = np.where(pend, q, 0)
        c = np.cumsum(alloc)
        e_try = base + c - alloc
        strad = pend & ((e_try // W) != ((e_try + q - 1) // W))
        if c[-1] > 0:
            total_q = int(base + c[-1])
            base = -(-(base + int(c[-1])) // W) * W
        pend = strad
    qs2 = np.where(pend, _pow2ceil_arr(np.maximum(ops, min_q)), 0)
    tail = int(qs2.sum())
    if tail > 0:
        total_q = base + tail
    return total_q


def _pow2ceil_arr(x: np.ndarray) -> np.ndarray:
    x = np.maximum(np.asarray(x, np.int64), 1)
    return 1 << np.ceil(np.log2(x.astype(np.float64))).astype(np.int64)


def srec_slots(a_indptr, rows_sorted, q_sorted, *, nnz: int, m: int,
               nl: Optional[int] = None):
    """The first half of ``build_srec``: each sorted A slot's row, its
    row's first slot, its A index and whether it is live, over NL slots
    (``nl`` bounds the live slots, from the planning pack). Returns (NL,
    rid_s, row_first, src, live_s)."""
    dev = a_indptr.device
    NL = max(nnz if nl is None else min(nl, nnz), 1)
    alen = a_indptr[1:] - a_indptr[:-1]
    alen_eff = torch.where(q_sorted > 0, alen[rows_sorted], 0)
    ca = cumsum1d(alen_eff)
    ca_excl = ca - alen_eff
    # sorted slot s belongs to sorted row rid_s: run-length decode
    slot = _arange(NL, dev)
    rid_s = torch.clamp(_decode(ca_excl, slot), 0, m - 1)
    src = a_indptr[rows_sorted[rid_s]] + (slot - ca_excl[rid_s])
    src = torch.clamp(src, 0, max(nnz - 1, 0))
    row_first = torch.clamp(ca_excl[rid_s], 0, NL - 1)
    return NL, rid_s, row_first, src, slot < ca[-1]


def srec_finish(e, slots, a32s, bst, blen, *, compact: bool = True):
    """The second half of ``build_srec``, from ``srec_slots``'s output and
    each slot's gathered A value bits, B row start and B row length."""
    NL, rid_s, row_first, src, live_s = slots
    blen = torch.where(live_s, blen, 0)
    cb = cumsum1d(blen)
    cb_excl = cb - blen
    cb_rowbase = cb_excl - cb_excl[row_first]
    p0 = torch.where(live_s, e[rid_s] + cb_rowbase, INT_MAX).to(I32)
    u = torch.where(live_s, bst - p0, 0)
    pend = torch.where(live_s, p0 + blen, 0)
    if not compact:
        return (p0, u, torch.where(live_s, a32s, 0),
                torch.where(live_s, src, 0), pend)
    keep = live_s & (blen > 0)
    rank = cumsum1d(keep.to(I32)) - 1
    tgt = torch.where(keep, rank, NL)

    def compact_(x, fill):
        out = _drop_buf(NL, fill, I32, e.device)
        out.index_put_((tgt,), x.to(I32))
        return out[:NL]

    return (compact_(p0, INT_MAX), compact_(u, 0), compact_(a32s, 0),
            compact_(src, 0), compact_(pend, 0))


def build_srec(a_indptr, a_indices, a_data32, b_start, b_len, rows_sorted,
               e, q_sorted, *, m: int, nl: Optional[int] = None,
               compact: bool = True):
    """Per-sorted-A-slot stream records (p0, su, sa, src, pend): each live
    A slot's stream start p0, u = b_row_start - p0, its value bits, its A
    index and its product end. ``nl`` bounds the live slots (from the
    planning pack). ``compact`` drops zero-product slots, so kept p0 is
    strictly increasing and an INT_MAX tail follows; without it every
    record stays in place (valid when one chunk sees all records)."""
    slots = srec_slots(a_indptr, rows_sorted, q_sorted,
                       nnz=a_indices.shape[0], m=m, nl=nl)
    src = slots[3]
    acol = a_indices[src]
    return srec_finish(e, slots, a_data32[src], b_start[acol], b_len[acol],
                       compact=compact)


def _order_stat(x: torch.Tensor, k) -> torch.Tensor:
    """The k-th smallest of x (k a device scalar, clamped into range)."""
    s = torch.sort(x).values
    return torch.take(s, torch.clamp(k, 0, x.shape[0] - 1).long())


def _dia_rows_mask(a_indptr, a_indices, b_indptr, b_indices, row_ops,
                   row_ops_f, a_len, *, m: int, dia_span_cap: int,
                   dia_waste_cap: float, dia_mem_budget: int,
                   dia_itemsize: int):
    """The per-row DIA split's device gate: a band with a 5%-per-side
    outlier allowance (order statistics of the per-row diagonal extents)
    selects the banded bulk. A row qualifies iff its own extent fits the
    robust band and every B row it touches is in band, so each C row is
    produced by one route. The whole-matrix gates (span, int32, waste,
    memory; dia.plane_bytes in f32 arithmetic) are evaluated here, and a
    failed gate empties the mask. Returns (dia_mask, [dlo_a, dhi_a, dlo_b,
    dhi_b, n_dia])."""
    dev = a_indptr.device
    nnz_a = a_indices.shape[0]
    kb = b_indptr.shape[0] - 1
    rowi = _arange(m, dev)
    ne_a = a_len > 0
    a_first = a_indices[torch.clamp(a_indptr[:-1], max=nnz_a - 1)] - rowi
    a_last = a_indices[torch.clamp(a_indptr[1:] - 1, min=0)] - rowi
    n_ne = torch.sum(ne_a, dtype=I32)
    pad = n_ne // 20
    dlo_a = _order_stat(torch.where(ne_a, a_first, INT_MAX), pad)
    dhi_a = _order_stat(torch.where(ne_a, a_last, INT_MAX), n_ne - 1 - pad)
    rowk = _arange(kb, dev)
    ne_b = (b_indptr[1:] - b_indptr[:-1]) > 0
    nnz_b = b_indices.shape[0]
    b_first = b_indices[torch.clamp(b_indptr[:-1], max=nnz_b - 1)] - rowk
    b_last = b_indices[torch.clamp(b_indptr[1:] - 1, min=0)] - rowk
    n_ne_b = torch.sum(ne_b, dtype=I32)
    padb = n_ne_b // 20
    dlo_b = _order_stat(torch.where(ne_b, b_first, INT_MAX), padb)
    dhi_b = _order_stat(torch.where(ne_b, b_last, INT_MAX),
                        n_ne_b - 1 - padb)
    # empty B rows are in band (they contribute nothing)
    b_in = (~ne_b) | ((b_first >= dlo_b) & (b_last <= dhi_b))
    a_in = ne_a & (a_first >= dlo_a) & (a_last <= dhi_a)
    # out-of-band B rows touched per A row, by a cumsum difference at the
    # row bounds (the reference's segment_min; empty rows fail a_in)
    zero = torch.zeros(1, dtype=I32, device=dev)
    bad = torch.cat([zero, cumsum1d((~b_in[a_indices]).to(I32))])
    all_b_in = (bad[a_indptr[1:]] - bad[a_indptr[:-1]]) == 0
    dia_mask = a_in & all_b_in & (row_ops > 0)
    sa_d = dhi_a - dlo_a + 1
    sb_d = dhi_b - dlo_b + 1
    # in float64: an exact sum of the rows' float32 counts in any order, so
    # the split's waste test is the same on the CPU and the card
    dia_ops = torch.sum(torch.where(dia_mask, row_ops_f, 0.0).double())
    saf, sbf = sa_d.float(), sb_d.float()
    scf = (sa_d + sb_d - 1).float()
    mf, kf = float(m), float(kb)
    planes_f = dia_itemsize * (2 * saf * mf + 2 * sbf * kf
                               + 2 * sbf * (mf + saf) + 2 * scf * mf
                               + 3 * scf * mf)
    ok = ((dlo_a <= dhi_a) & (dlo_b <= dhi_b)
          & (sa_d <= dia_span_cap) & (sb_d <= dia_span_cap)
          & (torch.maximum(torch.maximum(saf * mf, sbf * kf), scf * mf)
             < 2.0 ** 31)
          & (mf * saf * sbf <= dia_waste_cap * torch.clamp(dia_ops, min=1.0))
          & (planes_f <= float(dia_mem_budget)))
    dia_mask = dia_mask & ok
    n_dia = torch.sum(dia_mask, dtype=I32)
    return dia_mask, torch.stack([dlo_a, dhi_a, dlo_b, dhi_b, n_dia]).to(I32)


def _dense_tiles(a_indptr, a_indices, b_indptr, b_indices, row_ops, a_len,
                 dia_mask, *, m: int, tile_rows: int, kw_max: int,
                 cw_max: int, la_max: int, lb_max: int, max_tiles: int):
    """The dense-tile eligibility of the reference's planning pass: a tile
    qualifies when its A-column and output-column spans, longest A row and
    longest referenced B row fit the windows, it holds no per-row-DIA row,
    and it is among the first ``max_tiles`` such tiles. Returns (dense_mask
    (m,), [n_elig, kw_eff, cw_eff, la_eff, lb_eff], (r0, kb_s, cb_s,
    valid)): the eligible tiles first, in tile order, their row start,
    A-column base, output-column base and live rows; the rest pad with
    (m, 0, 0, 0)."""
    from .dense import tile_stats

    dev = a_indptr.device
    kmin, kspan, cmin, cspan, amax, bmax = tile_stats(
        a_indptr, a_indices, b_indptr, b_indices, row_ops, a_len,
        tile_rows=tile_rows, m=m)
    T = kmin.shape[0]
    elig = ((kspan <= kw_max) & (cspan <= cw_max) & (amax <= la_max)
            & (bmax <= lb_max) & (cspan > 0))
    padm = T * tile_rows - m
    dia_t = torch.cat([dia_mask, torch.zeros(padm, dtype=torch.bool,
                                             device=dev)]
                      ).reshape(T, tile_rows).any(dim=1)
    elig = elig & ~dia_t
    elig = elig & (torch.cumsum(elig.to(I32), 0) <= max_tiles)
    n_elig = torch.sum(elig, dtype=I32)
    tid = _arange(T, dev)
    # unique keys: the eligible tiles first, each group in tile order
    key_s, order = torch.sort(torch.where(elig, tid, T + tid))
    is_real = key_s < T
    r0 = torch.where(is_real, key_s * tile_rows, m)
    valid = torch.where(is_real, torch.clamp(m - key_s * tile_rows,
                                             max=tile_rows), 0)
    kb_s = torch.where(is_real, kmin[order], 0)
    cb_s = torch.where(is_real, cmin[order], 0)

    def eff(x):
        return torch.max(torch.where(elig, x, 0))

    pack = torch.stack([n_elig, eff(kspan), eff(cspan), eff(amax),
                        eff(bmax)]).to(I32)
    dense_mask = elig.repeat_interleave(tile_rows)[:m]
    return dense_mask, pack, tuple(x.to(I32) for x in (r0, kb_s, cb_s,
                                                        valid))


def plan_device_stream(a_indptr, a_indices, a_data32, b_indptr, b_indices,
                       row_ops, row_ops_f, a_len, *, min_q: int,
                       direct_ok: bool, m: int, w0: int = 8192,
                       w_cap: int = 65536, use_dia_rows: bool = False,
                       dia_span_cap: int = 512, dia_waste_cap: float = 8.0,
                       dia_mem_budget: int = 1 << 30, dia_itemsize: int = 4,
                       use_dense: bool = False, tile_rows: int = 256,
                       kw_max: int = 512, cw_max: int = 512, la_max: int = 64,
                       lb_max: int = 64, max_tiles: int = 0,
                       use_accum: bool = False, accum_min_ops: int = 1 << 14,
                       accum_span_cap: int = 1 << 20):
    """Single-pass device planning of the stream, direct, per-row DIA,
    dense-tile and accumulator routes: masks, the tight layout and ONE
    packed int32 array that carries every host decision (read back once by
    the caller). The pack has the reference's layout:

      [stream q-class hist (32) | direct class hist (32) | accum hist (32)
       | accum product sums (32) | n_eligible_tiles, kw, cw, la, lb (5) |
       gate scalars (7) | per-row DIA band dlo_a, dhi_a, dlo_b, dhi_b,
       n_dia (5) | n_live_slots, n_live_slots_accum (2) | W, total_q,
       n_wide, r_wide, wide_segs (N_WSEG_PACK)]

    with the accumulator entries zero unless ``use_accum``, the dense-tile
    entries zero unless ``use_dense`` (the eligibility count of
    ``_dense_tiles``), and the per-row DIA band [1, 0, 1, 0, 0] unless
    ``use_dia_rows``. Rows in ``dia_mask`` (the per-row split) or in an
    eligible dense tile ride neither the direct nor the stream route; a row
    of more than ``accum_min_ops`` products whose output columns span at
    most ``accum_span_cap`` rides the accumulator (``use_accum``).

    Returns (rows_sorted, e, q_sorted, el, ops_sorted, nnz_init, pack,
    dia_mask, r0, kb_s, cb_s, valid, e2, q2_sorted, cmin_sorted): r0 ..
    valid the sorted tile arrays (empty unless ``use_dense``), e2 and
    q2_sorted the accumulator product space and cmin_sorted each sorted
    row's first output column (zero unless ``use_accum``)."""
    dev = a_indptr.device
    if a_len is None:
        a_len = a_indptr[1:] - a_indptr[:-1]
    if row_ops_f is None:
        row_ops_f = row_ops.float()
    if (use_dia_rows and m > 0 and a_indices.shape[0] > 0
            and b_indices.shape[0] > 0):
        dia_mask, dia_pack = _dia_rows_mask(
            a_indptr, a_indices, b_indptr, b_indices, row_ops, row_ops_f,
            a_len, m=m, dia_span_cap=dia_span_cap,
            dia_waste_cap=dia_waste_cap, dia_mem_budget=dia_mem_budget,
            dia_itemsize=dia_itemsize)
    else:
        # an empty band, made on the device: no host-to-device copy
        dia_mask = torch.zeros(m, dtype=torch.bool, device=dev)
        dia_pack = torch.zeros(5, dtype=I32, device=dev)
        dia_pack[0:4:2] = 1
    if use_dense and m > 0:
        dense_mask, dense_pack, tiles = _dense_tiles(
            a_indptr, a_indices, b_indptr, b_indices, row_ops, a_len,
            dia_mask, m=m, tile_rows=tile_rows, kw_max=kw_max,
            cw_max=cw_max, la_max=la_max, lb_max=lb_max,
            max_tiles=max_tiles)
    else:
        dense_mask = torch.zeros(m, dtype=torch.bool, device=dev)
        dense_pack = torch.zeros(5, dtype=I32, device=dev)
        tiles = tuple(torch.zeros(0, dtype=I32, device=dev)
                      for _ in range(4))
    if direct_ok:
        direct_mask = ((a_len == 1) & (row_ops > 0) & ~dense_mask
                       & ~dia_mask)
    else:
        direct_mask = torch.zeros(m, dtype=torch.bool, device=dev)
    if use_accum and m > 0 and b_indices.shape[0] > 0:
        gcmin, span = _out_span(a_indptr, a_indices, b_indptr, b_indices,
                                m=m)
        accum_mask = ((row_ops > accum_min_ops) & (span <= accum_span_cap)
                      & ~dense_mask & ~direct_mask & ~dia_mask
                      & (row_ops > 0))
    else:
        gcmin = torch.zeros(m, dtype=I32, device=dev)
        span = torch.ones(m, dtype=I32, device=dev)
        accum_mask = torch.zeros(m, dtype=torch.bool, device=dev)
    stream_mask = ((row_ops > 0) & ~direct_mask & ~dense_mask & ~accum_mask
                   & ~dia_mask)
    (rows_sorted, e, q_sorted, el, ops_sorted, hist, tight_pack, e2,
     q2_sorted) = _plan_rows_impl(row_ops, stream_mask, direct_mask,
                                  min_q=min_q, m=m, w0=w0, w_cap=w_cap,
                                  accum_mask=accum_mask, span=span)
    # direct rows' exact counts come free from the analysis
    nnz_init = torch.where(direct_mask, row_ops, 0)
    gate = _gate_scalars(a_indptr, a_indices, b_indptr, b_indices, row_ops,
                         row_ops_f, a_len, m=m)
    n_live = torch.sum(torch.where(stream_mask, a_len, 0), dtype=I32)
    n_live2 = torch.sum(torch.where(accum_mask, a_len, 0), dtype=I32)
    pack = torch.cat([hist, dense_pack, gate, dia_pack,
                      torch.stack([n_live, n_live2]), tight_pack])
    return ((rows_sorted, e, q_sorted, el, ops_sorted, nnz_init, pack,
             dia_mask) + tiles + (e2, q2_sorted, gcmin[rows_sorted]))


def _out_span(a_indptr, a_indices, b_indptr, b_indices, *, m: int):
    """Each A row's output-column range (canonical B: a B row's range is
    its first and last column): (gcmin, span), span = last - first + 1,
    1 for a row with no products and gcmin 0 there, as in the reference's
    segment min and max."""
    from .dense import _row_ends, _segment_reduce

    dev = a_indptr.device
    nnz = a_indices.shape[0]
    _, b_cmin, b_cmax = _row_ends(b_indptr, b_indices)
    seg = _count_le(a_indptr[1:], _arange(nnz, dev))
    gcmin = _segment_reduce(b_cmin[a_indices], seg, a_indptr, "amin")
    gcmax = _segment_reduce(b_cmax[a_indices], seg, a_indptr, "amax")
    span = torch.clamp(gcmax - torch.minimum(gcmin, gcmax) + 1, min=1)
    gcmin = torch.where(gcmax < 0, 0, gcmin)
    return gcmin.to(I32), span.to(I32)


def _gate_scalars(a_indptr, a_indices, b_indptr, b_indices, row_ops,
                  row_ops_f, a_len, *, m: int):
    """The 7 routing/guard scalars as one int32 array:
    [a_dmin, a_dmax, b_dmin, b_dmax, sp_sat, mxrow_sat, sp_exact]."""
    dev = a_indptr.device
    big = torch.full((), INT_MAX, dtype=I32, device=dev)
    if a_indices.shape[0] > 0 and m > 0:
        rowi = _arange(m, dev)
        ne_a = a_len > 0
        a_first = a_indices[a_indptr[:-1].clamp(max=a_indices.shape[0] - 1)
                            ] - rowi
        a_last = a_indices[torch.clamp(a_indptr[1:] - 1, min=0)] - rowi
        a_dmin = torch.min(torch.where(ne_a, a_first, INT_MAX))
        a_dmax = torch.max(torch.where(ne_a, a_last, -INT_MAX))
    else:
        a_dmin, a_dmax = big, -big
    kd = b_indptr.shape[0] - 1
    if b_indices.shape[0] > 0 and kd > 0:
        rowk = _arange(kd, dev)
        ne_b = (b_indptr[1:] - b_indptr[:-1]) > 0
        b_first = b_indices[b_indptr[:-1].clamp(max=b_indices.shape[0] - 1)
                            ] - rowk
        b_last = b_indices[torch.clamp(b_indptr[1:] - 1, min=0)] - rowk
        b_dmin = torch.min(torch.where(ne_b, b_first, INT_MAX))
        b_dmax = torch.max(torch.where(ne_b, b_last, -INT_MAX))
    else:
        b_dmin, b_dmax = big, -big
    # the total in float64: an exact sum of the rows' float32 counts in any
    # order, so the gates on it are the same on the CPU and the card
    pos_f = torch.clamp(row_ops_f, min=0.0).double()
    sp_sat = torch.clamp(pos_f.sum(), 0.0, 2.0 ** 31 - 2).to(I32)
    mxrow_sat = torch.clamp(pos_f.max() if m > 0 else pos_f.sum(),
                            0.0, 2.0 ** 31 - 2).to(I32)
    sp_exact = torch.sum(torch.clamp(row_ops, min=0), dtype=I32)
    return torch.stack([a_dmin, a_dmax, b_dmin, b_dmax, sp_sat, mxrow_sat,
                        sp_exact]).to(I32)


def plan_gate(a_indptr, a_indices, b_indptr, b_indices, row_ops, row_ops_f,
              *, m: int):
    """The early routing gate: only the 7 gate scalars."""
    a_len = a_indptr[1:] - a_indptr[:-1]
    if row_ops_f is None:
        row_ops_f = row_ops.float()
    return _gate_scalars(a_indptr, a_indices, b_indptr, b_indices, row_ops,
                         row_ops_f, a_len, m=m)


# ---------------------------------------------------------------------------
# Chunk
# ---------------------------------------------------------------------------


class ChunkRecords(NamedTuple):
    """What every chunk of one product space reads: the A-slot records
    (``build_srec``), the expand's B operand, each chunk's first record
    and the chunk shape. Chunk c covers the stream slots from c * G * W
    on, in ``rows(c)`` rectangle rows of W; each chunk reads its records
    from a window sized by the full chunk (``expand.expand_plain``).

    ``sa`` is the record channel: a float32 A's value bits, else the
    A-source map. ``spgemm._stream_operands`` binds ``b`` (a plan keeps
    its bundles unbound) and puts the channel of new values there."""

    e: torch.Tensor          # (m,) each sorted row's stream start
    p0: torch.Tensor         # A-slot stream starts
    su: torch.Tensor         # u = b_row_start - p0 per A slot
    sa: torch.Tensor         # the record channel
    src: torch.Tensor        # A slot -> A nonzero index
    pend: torch.Tensor       # A-slot product ends (p0 + b_len)
    b: Any                   # packed (nnz, 2) B record or expand.Unpacked
    sid_bases: torch.Tensor  # (n_chunks,) records with p0 < chunk start
    G: int                   # rectangle rows of a chunk
    g_last: int              # rectangle rows of the last chunk (<= G)
    W: int
    n_chunks: int
    n_cols: int
    pack_bits: int           # 0: the two-key chunk sort

    def rows(self, c: int) -> int:
        return self.g_last if c == self.n_chunks - 1 else self.G


def chunk_expand(rec: ChunkRecords, c: int, live: Optional[int] = None):
    """Chunk c's expand (kernel K4): (rid, col, val), each (rows(c), W).
    ``live``: the chunk's products, where the caller knows them."""
    CP = rec.G * rec.W
    return stream_expand(rec.e, rec.p0, rec.su, rec.sa, rec.pend, rec.b,
                         c * CP, rec.sid_bases[c], rec.rows(c), rec.W,
                         rec.n_cols, CP, live)


def _sort_rect(rid, col, val, n_cols: int, pack_bits: int,
               live: Optional[int] = None):
    """Sort each rectangle row by (rid, col) with every dead slot
    (col >= n_cols) last (kernel K2). pack_bits > 0: one sort on the packed
    key (rid - rid0) << pack_bits | col; dead slots keep rid0. pack_bits ==
    0 (the packed key would overflow int32): two stable passes, by column
    and then by rid - rid0 with dead slots at W, each key within its own
    small range, which is the reference's two-key sort with dead rids at
    INT_MAX; dead slots carry rid INT_MAX, as there. ``live``: the
    rectangle's products, where the caller knows them (each K2 launch's
    live slots)."""
    rid0 = rid[:, :1]
    if pack_bits > 0:
        keyk = ((rid - rid0) << pack_bits) | col
        keyk = torch.where(col >= n_cols, INT_MAX, keyk).to(I32).contiguous()
        keyk, (moved,) = row_sort(keyk, [slot_payload(val)], live)
        dead = keyk == INT_MAX
        col_s = torch.where(dead, n_cols, keyk & ((1 << pack_bits) - 1))
        rid_s = torch.where(dead, rid0, rid0 + (keyk >> pack_bits))
        return rid_s.to(I32), col_s.to(I32), by_slot(val, moved)
    W = col.shape[1]
    dead = col >= n_cols
    rel = torch.where(dead, W, rid - rid0).to(I32).contiguous()
    col1, (rel1, moved1) = row_sort(col.to(I32).contiguous(),
                                    [rel, slot_payload(val)], live)
    key2, (col_s, moved) = row_sort(rel1, [col1, moved1], live)
    rid_s = torch.where(key2 >= W, INT_MAX, rid0 + key2)
    return rid_s.to(I32), col_s, by_slot(val, moved)


def _sort_cols(col, val, live: Optional[int] = None):
    """Single-key (col, val) row sort (kernel K2); a level under a factor
    that is not a power of two has a width that is not one either, which
    K2 sorts padded. ``live``: the real entries, where the caller knows
    them."""
    col_s, (moved,) = row_sort(col.contiguous(), [slot_payload(val)], live)
    return col_s, by_slot(val, moved)


def _row_last(rid_s, col_s, n_cols: int):
    """Run-last mask of sorted rows, recomputed from neighbour changes."""
    G = col_s.shape[0]
    dev = col_s.device
    changed = torch.cat(
        [torch.ones((G, 1), dtype=torch.bool, device=dev),
         (col_s[:, 1:] != col_s[:, :-1]) | (rid_s[:, 1:] != rid_s[:, :-1])],
        dim=1)
    nxt = torch.cat([changed[:, 1:],
                     torch.ones((G, 1), dtype=torch.bool, device=dev)], dim=1)
    return nxt & (col_s < n_cols)


def _compact_rect(last, rid_s, col_s, run_sum, compact_impl: str = "sort"):
    """Move run-last entries to the rectangle-row front, order kept.
    ``rid_s`` None skips that plane (rows with a constant rid). Returns
    (rid_c, col_c, val_c, counts).

    compact_impl="sort": one rank sort (kernel K2; the rest follow in slot
    order). "scatter": each plane scattered to g * W + rank, the exclusive
    count of run-lasts before the slot in its row; the targets are unique,
    so the result is deterministic, and the rest hold (INT_MAX, INT_MAX,
    0). Both are equal on every row's live prefix."""
    G, W = col_s.shape
    rank = torch.cumsum(last, 1, dtype=I32) - 1
    counts = torch.sum(last, 1, dtype=I32)
    if compact_impl == "scatter":
        g = _arange(G, col_s.device)[:, None]
        flat = torch.where(last, g * W + rank, G * W).reshape(-1)

        def sc(x, fill):
            out = _drop_buf(G * W, fill, x.dtype, x.device)
            out[flat] = x.reshape(-1)
            return out[:-1].view(G, W)

        return (None if rid_s is None else sc(rid_s, INT_MAX),
                sc(col_s, INT_MAX), sc(run_sum, 0), counts)
    t = _arange(W, col_s.device)[None, :]
    key = torch.where(last, rank, W + t).to(I32).contiguous()
    pay = [col_s.contiguous(), slot_payload(run_sum)]
    if rid_s is not None:
        pay.insert(0, rid_s.contiguous())
    _, out = row_sort(key, pay)
    val_c = by_slot(run_sum, out[-1])
    if rid_s is None:
        return None, out[0], val_c, counts
    return out[0], out[1], val_c, counts


def compact_staged(rid_s, col_s, val_s, counts, *, n_cols: int,
                   compact_impl: str = "sort"):
    """Compact a raw staged chunk (sorted planes from
    stream_chunk(stage_raw=True)): run-last flags are recomputed and the
    partial run sums at those slots are already the full sums."""
    return _compact_rect(_row_last(rid_s, col_s, n_cols), rid_s, col_s,
                         val_s, compact_impl)


def chunk_sorted(rec: ChunkRecords, c: int, live: Optional[int] = None):
    """Chunk c's expand (K4), its (rid, col) row sort (K2) and contract
    (K1): (rid_s, col_s, last, run_sum). ``live``, the chunk's products
    where the caller knows them, goes to the three launch counters."""
    rid, col, val = chunk_expand(rec, c, live)
    rid_s, col_s, val_s = _sort_rect(rid, col, val, rec.n_cols,
                                     rec.pack_bits, live)
    last, run_sum = stream_contract(rid_s, col_s, val_s, rec.n_cols, live)
    return rid_s, col_s, last, run_sum


def stream_chunk(rec: ChunkRecords, c: int, rows_sorted, q_sorted, el,
                 ops_sorted, nnz_row, *, stage: bool, stage_raw: bool = False,
                 compact_impl: str = "sort", live: Optional[int] = None):
    """One fused count(+stage) pass over chunk c (``chunk_sorted``). Every
    row contained in the chunk gets its exact nnz in ``nnz_row`` (padded
    by one drop slot, updated in place) by an O(m) segment difference
    over per-rectangle-row cumulative run-last counts. stage=True also
    returns the compacted (rid, col, val, counts) rectangle rows;
    stage_raw returns them sorted but uncompacted. ``compact_impl`` is
    ``SpgemmConfig.stream_compact_impl``."""
    rid_s, col_s, last, run_sum = chunk_sorted(rec, c, live)

    e = rec.e
    dev = e.device
    m = rows_sorted.shape[0]
    G, W = rec.rows(c), rec.W
    chunk_start = c * rec.G * W
    CP = G * W
    cl = torch.cumsum(last, 1, dtype=I32).reshape(-1)
    contained = ((q_sorted > 0) & (q_sorted <= W) & (e >= chunk_start)
                 & (e < chunk_start + CP))
    g = torch.clamp(torch.div(e - chunk_start, W, rounding_mode="floor"),
                    0, G - 1)
    g_first = torch.searchsorted(e, chunk_start + _arange(G, dev) * W,
                                 out_int32=True)
    lrel = el - el[torch.clamp(g_first[g], 0, m - 1)]
    seg_end = g * W + lrel + ops_sorted - 1
    seg_before = g * W + lrel - 1
    cnt = (cl[torch.clamp(seg_end, 0, CP - 1)]
           - torch.where(lrel > 0, cl[torch.clamp(seg_before, 0, CP - 1)],
                         0))
    cnt = torch.where(contained & (ops_sorted > 0), cnt, 0)
    nnz_row.index_put_((torch.where(contained, rows_sorted, m),),
                       cnt.to(I32))

    if not stage:
        return nnz_row, None
    if stage_raw:
        counts = torch.sum(last, 1, dtype=I32)
        return nnz_row, (rid_s, col_s, run_sum, counts)
    return nnz_row, _compact_rect(last, rid_s, col_s, run_sum, compact_impl)


def stream_chunk_numeric(rec: ChunkRecords, c: int, rows_sorted,
                         row_offsets, c_cols, c_vals, n_wide, *,
                         stage_wide: bool, compact_impl: str = "sort",
                         live: Optional[int] = None):
    """Two-phase numeric pass over chunk c: the same ``chunk_sorted``
    step, then contained rows' run-last entries scatter straight to their
    offsets in C (padded buffers, updated in place); the first ``n_wide``
    sorted rows (the accumulator and wide rows) emit elsewhere.
    stage_wide also returns the compacted rectangle rows for the merge
    levels. ``live`` as ``stream_chunk``'s."""
    rid_s, col_s, last, run_sum = chunk_sorted(rec, c, live)
    n_cols = rec.n_cols

    # rank among the row's run-lasts via a segmented exclusive count; the
    # live slots are sorted by rid, the dead ones (col >= n_cols) last
    cl = torch.cumsum(last, 1, dtype=I32)
    ce = cl - last.to(I32)
    first = _run_start(torch.where(col_s >= n_cols, INT_MAX, rid_s))
    rank = ce - torch.gather(ce, 1, first.long())
    m = rows_sorted.shape[0]
    row = rows_sorted[torch.clamp(rid_s, 0, m - 1)]
    emit = last & (rid_s >= n_wide)
    flat = torch.where(emit, row_offsets[row] + rank, c_cols.shape[0] - 1)
    c_cols.index_put_((flat,), col_s)
    c_vals.index_put_((flat,), run_sum.to(c_vals.dtype))
    if not stage_wide:
        return c_cols, c_vals, None
    return c_cols, c_vals, _compact_rect(last, rid_s, col_s, run_sum,
                                         compact_impl)


# ---------------------------------------------------------------------------
# The dense-span accumulator
# ---------------------------------------------------------------------------


def stream_chunk_accum(rec: ChunkRecords, c: int, abase, cmin_s, acc, pres,
                       row_lo: int, row_hi: int):
    """One expand and scatter-add pass over chunk c of the accumulator
    product space: the products of sorted rows in the active part
    [row_lo, row_hi) add into acc[abase[rid] + col - cmin_s[rid]] and
    mark ``pres`` there (abase is part-local); the other rows' products
    and the dead slots go to the trailing drop slot of ``acc`` and
    ``pres`` (updated in place).

    The reference's dense mode for single huge rows: no sort, one
    scatter-add a product. The adds are ``index_add_`` (atomics on the
    card) into ``acc``'s type (the caller's float64 plane), so the order
    in which equal columns sum changes from launch to launch: values agree
    to rounding, not to the bit; the int32 presence is exact."""
    rid, col, val = chunk_expand(rec, c)
    n_cols = rec.n_cols
    na = abase.shape[0]
    rid_c = torch.clamp(rid, 0, na - 1)
    live = (col < n_cols) & (rid >= row_lo) & (rid < row_hi)
    drop = acc.shape[0] - 1
    tgt = torch.where(live, abase[rid_c] + (col - cmin_s[rid_c]), drop)
    tgt = tgt.reshape(-1)
    acc.index_add_(0, tgt, val.reshape(-1).to(acc.dtype))
    pres.index_fill_(0, tgt.long(), 1)
    return acc, pres


def accum_finalize(rows_sorted, acc_slice, pres_slice, cmin_s, rid_of_out,
                   nnz_row, *, R_c: int, S_c: int, count: bool):
    """One span class's accumulators as staged compacted rows: presence
    gives the exact counts (set into ``nnz_row`` in place when ``count``),
    a present slot's column is cmin + its index, so the rows come out
    sorted; the rank compaction is kernel K2 (``_compact_rect``). Returns
    (nnz_row, (rid, col_c, val_c, counts)) in ``stream_emit``'s staged
    format."""
    acc = acc_slice.reshape(R_c, S_c)
    pres = pres_slice.reshape(R_c, S_c)
    idx = _arange(S_c, acc.device)[None, :]
    m = rows_sorted.shape[0]
    rid_b = rid_of_out[:, None].expand(R_c, S_c)
    last = (pres > 0) & (rid_b >= 0)
    cols = torch.where(last, cmin_s[torch.clamp(rid_b, 0, m - 1)] + idx,
                       0).to(I32)
    if count:
        tgt = torch.where(rid_of_out >= 0,
                          rows_sorted[torch.clamp(rid_of_out, 0, m - 1)], m)
        nnz_row.index_put_((tgt,), torch.sum(last, 1, dtype=I32))
    _, col_c, val_c, counts = _compact_rect(last, None, cols, acc)
    return nnz_row, (rid_of_out, col_c, val_c, counts)


# ---------------------------------------------------------------------------
# Wide rows
# ---------------------------------------------------------------------------


def stream_level(rows_sorted, rid_in, col_in, val_in, counts_in, in_map,
                 final_mask, nnz_row, *, F: int, W_in: int, n_cols: int,
                 count: bool = True, compact_impl: str = "sort",
                 live: Optional[int] = None):
    """One merge level: each output rectangle row re-sorts F input
    segments (compacted prefixes of width W_in) of one wide row and
    contracts them; rows whose segments all fit here (final_mask) are
    counted into ``nnz_row`` (padded, in place). in_map (R_out, F): input
    rectangle-row indices, -1 for none. ``live``: the input entries, where
    the caller knows them."""
    dev = col_in.device
    R_out = in_map.shape[0]
    W_out = F * W_in
    srcrow = in_map.reshape(-1)
    okrow = srcrow >= 0
    src = torch.clamp(srcrow, 0, max(rid_in.shape[0] - 1, 0))
    j = _arange(W_in, dev)[None, :]
    livein = okrow[:, None] & (j < counts_in[src][:, None])
    col = torch.where(livein, col_in[src], n_cols).reshape(R_out, W_out)
    val = torch.where(livein, val_in[src], 0.0).reshape(R_out, W_out)
    rid_out = torch.max(torch.where(okrow, rid_in[src], -1).reshape(R_out, F),
                        dim=1).values.to(I32)

    col_s, val_s = _sort_cols(col.to(I32), val, live)
    rid_b = rid_out[:, None].expand(R_out, W_out)
    last, run_sum = stream_contract(rid_b, col_s, val_s, n_cols, live)
    if count:
        # each final row's run-lasts, added at its matrix row (one output
        # row per final wide row)
        m = rows_sorted.shape[0]
        fin = final_mask & (rid_out >= 0)
        tgt = torch.where(fin, rows_sorted[torch.clamp(rid_out, 0, m - 1)],
                          m)
        nnz_row.index_add_(0, tgt, torch.where(
            fin, torch.sum(last, 1, dtype=I32), 0))
    _, col_c, val_c, counts = _compact_rect(last, None, col_s, run_sum,
                                            compact_impl)
    return nnz_row, (rid_out, col_c, val_c, counts)


def wide_entry_totals(wcnt, wide_rid, *, n_wide: int):
    """Per-wide-row total staged entries after level 0."""
    return torch.zeros(n_wide, dtype=I32, device=wcnt.device).index_add_(
        0, wide_rid, wcnt)


def stream_wide_finish(rows_sorted, wcol_flat, wval_flat, wcnt, entry_excl,
                       row_total, rid_of_out, nnz_row, *, R2: int, W2: int,
                       W0: int, E_pad: int, n_cols: int, count: bool,
                       compact_impl: str = "sort",
                       live: Optional[int] = None):
    """Adaptive wide-row finish: gather each wide row's staged entries into
    one (R2, W2) rectangle sized by the true entry totals, then one sort
    and contract completes the row (counts set into ``nnz_row`` in place).
    wcol_flat/wval_flat: the flattened (r_wide * W0) staged wide buffers;
    wcnt: per-rectangle-row live counts; entry_excl/row_total/rid_of_out:
    host-computed per output row; ``live``: the sum of row_total, where
    the caller has it on the host."""
    dev = wcol_flat.device
    r_wide = wcnt.shape[0]
    ccum = cumsum1d(wcnt)
    ccum_excl = ccum - wcnt
    # entry id -> source rectangle row: run-length decode
    rr_tab = torch.clamp(_decode(ccum_excl, _arange(E_pad, dev)), 0,
                         r_wide - 1)

    j = _arange(W2, dev)[None, :]
    e_id = entry_excl[:, None] + j
    dead = (j >= row_total[:, None]) | (e_id >= E_pad)
    e_c = torch.clamp(e_id, 0, E_pad - 1)
    rr = rr_tab[e_c]
    src = torch.clamp(rr * W0 + (e_c - ccum_excl[rr]), 0,
                      wcol_flat.shape[0] - 1)
    col = torch.where(dead, n_cols, wcol_flat[src]).to(I32)
    val = torch.where(dead, 0.0, wval_flat[src])

    col_s, val_s = _sort_cols(col, val, live)
    rid_b = rid_of_out[:, None].expand(R2, W2)
    last, run_sum = stream_contract(rid_b, col_s, val_s, n_cols, live)
    if count:
        m = rows_sorted.shape[0]
        tgt = torch.where(rid_of_out >= 0,
                          rows_sorted[torch.clamp(rid_of_out, 0, m - 1)], m)
        nnz_row.index_put_((tgt,), torch.sum(last, 1, dtype=I32))
    _, col_c, val_c, counts = _compact_rect(last, None, col_s, run_sum,
                                            compact_impl)
    return nnz_row, (rid_of_out, col_c, val_c, counts)


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------


def stream_emit(rows_sorted, rid_c, col_c, val_c, counts, row_offsets,
                c_cols, c_vals, min_rid=0):
    """Scatter a final wide-row buffer's compacted entries into C's padded
    buffers (in place): entries of row r go to row_offsets[r] + rank;
    rows with rid < 0 are padding. ``min_rid`` (>= 0, an int or a device
    scalar) skips the sorted rows before it: a staged chunk passes the
    wide-row count, so only its contained rows emit."""
    R, W = col_c.shape
    t = _arange(W, col_c.device)[None, :]
    live = (t < counts[:, None]) & (rid_c >= min_rid)
    # the compacted prefix is sorted by rid; the rest is masked
    rank = t - _run_start(torch.where(t < counts[:, None], rid_c, INT_MAX))
    m = rows_sorted.shape[0]
    row = rows_sorted[torch.clamp(rid_c, 0, m - 1)]
    flat = torch.where(live, row_offsets[row] + rank, c_cols.shape[0] - 1)
    c_cols.index_put_((flat,), col_c)
    c_vals.index_put_((flat,), val_c.to(c_vals.dtype))
    return c_cols, c_vals


def stream_gather_emit(rows_sorted, e, row_offsets, cols_flat, vals_flat, *,
                       W: int, nnz: int):
    """Build the contained-row part of C by gathering from the
    concatenated staged chunks: a contained row's entries are the
    compacted prefix of one rectangle row, so the per-row source base is
    seeded at each row's output start and forward-filled. Returns padded
    (max(nnz, 1) + 1) buffers; rows outside the stream get garbage here
    and are overwritten by their own emission."""
    dev = e.device
    m = rows_sorted.shape[0]
    total = max(nnz, 1)
    R_total = cols_flat.shape[0] // W
    nnz_row = row_offsets[1:] - row_offsets[:-1]
    scnt = nnz_row[rows_sorted]
    scum = cumsum1d(scnt) - scnt
    gg_first = torch.searchsorted(e, _arange(max(R_total, 1), dev) * W,
                                  out_int32=True)
    rect_base = scum[torch.clamp(gg_first, 0, m - 1)]
    gg_s = torch.clamp(torch.div(e, W, rounding_mode="floor"), 0,
                       max(R_total - 1, 0))
    base_sorted = (gg_s * W + scum - rect_base[gg_s]
                   - row_offsets[rows_sorted])
    # the base is constant over each row's output segment: look up the
    # row of every output index (the reference seeds and forward-fills it)
    base_row = torch.zeros(m, dtype=I32, device=dev)
    base_row[rows_sorted] = base_sorted.to(I32)
    i = _arange(total, dev)
    row_i = _count_le(row_offsets[1:], i)
    src = torch.clamp(base_row[torch.clamp(row_i, 0, m - 1)] + i, 0,
                      cols_flat.shape[0] - 1)
    c_cols = torch.empty(total + 1, dtype=I32, device=dev)
    c_vals = torch.empty(total + 1, dtype=vals_flat.dtype, device=dev)
    c_cols[:total] = cols_flat[src]
    c_vals[:total] = vals_flat[src]
    return c_cols, c_vals


# ---------------------------------------------------------------------------
# Host-side stream layout (numpy, driven by the planning readback)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    """Everything the host derives from the planning readback: chunk
    schedule, wide-row segment table."""

    W: int
    G: int                    # rect rows per chunk
    g_last: int               # rect rows of the last chunk (<= G)
    n_chunks: int
    total_q: int              # stream length (sum of allocations)
    n_wide: int               # wide rows (q > W), first in sorted order
    r_wide: int               # rect rows owned by wide rows
    wide_segs: np.ndarray     # (n_wide,) segments per wide row
    n_stream_rows: int
    n_direct_rows: int
    direct_classes: List[Tuple[int, int, int]]  # (cap, start, count)


def plan_layout(hist: np.ndarray, d_hist: np.ndarray, W: int,
                product_budget: int, *, total_q: Optional[int] = None,
                n_wide: Optional[int] = None, r_wide: Optional[int] = None,
                wide_segs: Optional[np.ndarray] = None) -> StreamLayout:
    """The full stream layout from the planning readback. With the
    tight-layout keywords the exact totals are used; without them
    (pow2 mode) they come from the class histogram. The int32 ceiling
    guard always uses the pow2 class bound."""
    qs = 1 << np.arange(N_QCLASS, dtype=np.int64)
    class_sum = int((hist.astype(np.int64) * qs).sum())
    if class_sum + 4 * W >= 2**31:
        raise ProductOverflow(
            f"stream of ~{class_sum} quantized products exceeds the 2^31 "
            "int32 ceiling; row-block the multiply")
    n_stream_rows = int(hist.sum())
    if total_q is None:
        total_q = class_sum
        wide_classes = [k for k in range(N_QCLASS)
                        if (1 << k) > W and hist[k]]
        n_wide = int(sum(hist[k] for k in wide_classes))
        wide_segs = np.concatenate([
            np.full(int(hist[k]), (1 << k) // W, np.int64)
            for k in sorted(wide_classes, reverse=True)
        ]) if n_wide else np.zeros(0, np.int64)
        r_wide = int(wide_segs.sum())
    else:
        wide_segs = np.asarray(wide_segs, np.int64)

    G = max(1, product_budget // W)
    need = -(-max(total_q, 1) // W)
    if need < G:
        G = max(8, -(-need // 8) * 8) if need > 8 else max(1, need)
    n_chunks = -(-total_q // (G * W)) if total_q else 0
    g_last = G
    if n_chunks > 1:
        rem = need - (n_chunks - 1) * G
        if rem < G and (n_chunks - 1) * G >= (r_wide or 0):
            g_last = max(8, -(-rem // 8) * 8) if rem > 8 else max(1, rem)

    n_direct = int(d_hist.sum())
    direct_classes = []
    start = n_stream_rows
    for k in range(N_QCLASS - 1, -1, -1):
        cnt = int(d_hist[k])
        if cnt:
            direct_classes.append((1 << k, start, cnt))
            start += cnt
    return StreamLayout(
        W=W, G=G, g_last=g_last, n_chunks=n_chunks, total_q=total_q,
        n_wide=n_wide, r_wide=r_wide, wide_segs=wide_segs,
        n_stream_rows=n_stream_rows, n_direct_rows=n_direct,
        direct_classes=direct_classes,
    )


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One merge level: in_map rows of the previous buffer into F-wide
    output rectangle rows; final rows finish (count + emit) here."""

    F: int
    W_in: int
    in_map: np.ndarray      # (R_out, F) int32, -1 padded
    final_mask: np.ndarray  # (R_out,) bool
    segs_out: np.ndarray    # (n_unfinished_rows,) for the next level


def plan_levels(layout: StreamLayout, F: int = 4,
                max_width: int = 1 << 24) -> List[LevelPlan]:
    """Merge-level schedule for the wide rows (host numpy): level 0 input
    is the first r_wide rectangle rows; each level groups up to F
    consecutive segments of one row; a row is final when its remaining
    segments fit one output row."""
    plans: List[LevelPlan] = []
    segs = layout.wide_segs.copy()
    rows = np.arange(layout.n_wide)
    W_in = layout.W
    while len(rows):
        starts = np.concatenate([[0], np.cumsum(segs)])[:-1]
        f_eff = min(F, max(max_width // W_in, 2))
        out_rows, final, segs_out, keep_rows = [], [], [], []
        for i, r in enumerate(rows):
            s0, ns = int(starts[i]), int(segs[i])
            n_out = -(-ns // f_eff)
            for o in range(n_out):
                seg_ids = np.full(f_eff, -1, np.int64)
                lo = s0 + o * f_eff
                hi = min(s0 + ns, lo + f_eff)
                seg_ids[: hi - lo] = np.arange(lo, hi)
                out_rows.append(seg_ids)
                final.append(n_out == 1)
            if n_out > 1:
                keep_rows.append(r)
                segs_out.append(n_out)
        plans.append(LevelPlan(
            F=f_eff, W_in=W_in,
            in_map=np.asarray(out_rows, np.int32).reshape(-1, f_eff),
            final_mask=np.asarray(final, bool),
            segs_out=np.asarray(segs_out, np.int64),
        ))
        rows = np.asarray(keep_rows)
        segs = np.asarray(segs_out, np.int64)
        W_in = W_in * f_eff
    return plans
