"""The row-sharded stream mesh (the port of
``speck_tpu/parallel/mesh_stream.py``).

Each shard runs the full stream pipeline on its local A rows: planning
(``ops.stream._plan_rows_impl`` with the tight layout at a fixed width W,
``build_srec``), (G, W) chunks with the two-key chunk sort (``pack_bits =
0``: two passes of kernel K2) and the contract (kernel K1), the wide-row
merge ladder with host-planned absolute ``in_map`` schedules padded to one
common shape across shards (``_mesh_wide_plans``), device offsets and the
emission into a padded (out_cap,) output. Retained staging is capped by
``cfg.fused_staging_budget``: past it, contained chunks count only and
re-expand straight into C in the emission pass (two-phase staging).
Rows past ``cfg.mesh_split_min_ops`` products leave the ladder by k-split:
their slots are re-dealt by B-row owner, every shard computes a partial
row from its own B rows, and an all_gather plus one K2 sort, K1 and K2
compaction merges them at the owner (``_ksplit_merge``).

B moves over the mesh (``parallel/dist.py`` holds the collectives and the
single-controller loop that stands in for ``shard_map``):

- ``exchange="allgather"``: every shard gathers all B row shards.
- ``exchange="needset"``: per (dst, src) shard pair, exactly the B rows
  dst's A columns reference move, in D-1 round-robin ``ppermute`` rounds
  (round r: src s -> dst (s + r) % D), each padded to its own largest
  pair; round 0 is the local self-need. The plan is computed on the
  devices (``_plan_needset_device``, one D^2 readback) or, with
  ``mesh_device_planning=False``, on the host. When the padded plan would
  move more than all_gather, ``mesh_exchange_auto`` falls back to
  all_gather (``mode="allgather(auto)"``).
- ``exchange="needset_overlap"``: the same plan; every row goes to the
  last round its columns need, and each round's rows run as their own
  masked pipeline over the received buffer's prefix of rounds <= r, so a
  round group waits only for its rounds (``_OverlapStep``).

Two more routes take the inputs the reference's gates send them:

- the diagonal-plane route (``_mesh_sdia_gate``, ``_mesh_sdia_spgemm``):
  banded and stencil inputs, whatever the exchange, as per-shard diagonal
  planes convolved over a ring halo of O(span * planes) moved by two
  ``ppermute`` rounds;
- the dense-window route (``_mesh_dense_gate``, ``_mesh_dense_spgemm``):
  tile-bounded inputs under ``exchange="allgather"``, B gathered whole,
  each shard's row tiles as densified window products (``ops/dense.py``).

Conventions as in ``ops/stream.py``: int32 everywhere, and every scatter
the reference writes with ``mode="drop"`` targets a buffer with a
trailing drop slot. The outputs are global (D*m_loc,), (D*out_cap,) and
(D*out_cap,) tensors on the first local shard's device, as the reference's
sharded arrays; ``mesh_stream_to_host_csr`` assembles them.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from ..formats.csr import HostCSR
from ..ops.analysis import cumsum1d
from ..ops.bitonic import by_slot, slot_payload
from ..ops.contract import VALUE_DTYPES, stream_contract
from ..ops.dense import (_densify_scatter, _densify_sorted,
                         _full_precision_bmm, _gather_rect)
from ..ops.device_csr import torch_dtype
from ..ops.dia import _rank_compact, dia_planes, sdia_lut
from ..ops.esc import _sort_rows, pack_csr_arrays
from ..ops.expand import Unpacked
from ..ops.spgemm import _pow2 as _pow2ceil
from ..ops.spgemm import check_knobs
from ..ops.stream import (ChunkRecords, _compact_rect, _count_le,
                          _plan_rows_impl, _pow2ceil_arr, _sort_cols,
                          build_srec, stream_chunk, stream_chunk_numeric,
                          stream_emit, stream_level, tight_total_host)
from ..utils.config import SpgemmConfig
from ..utils.timings import span
from .dist import (RowMesh, _host_all_gather, _np_dtype, _pad_to,
                   _slice_rows, all_gather, assemble, fetch_global,
                   fetch_output, ppermute, ppermute_start, process_count, put,
                   put_values, upload)

I32 = torch.int32


def _mesh_wide_plans(shard_ops: List[np.ndarray], W: int, F: int,
                     max_width: int, n_cols: Optional[int] = None):
    """Host ladder plans for the per-shard wide-row merge levels.

    Per shard: wide rows (ops > W, device sort order = ops descending;
    ties have equal segment counts, so host order is interchangeable) own
    ceil(ops/W) level-0 rectangle rows; each level merges up to f_eff
    consecutive segments of one row into one output row of width
    f_eff * W_in. in_maps are ABSOLUTE into the full previous buffer, and
    all shards are padded to one common (R_out, depth) schedule; pad rows
    carry in_map = -1 and final = False and produce nothing. Every level's
    buffers are truncated to pow2ceil(n_cols) columns (a compacted segment
    never holds more distinct columns), which is lossless.

    Returns (r_wide_max, wide_rid (D, r_wide_max), specs) where specs is
    a list of dicts {F, W_in, R_out, in_map (D, R_out, F), final
    (D, R_out), W_buf_in, W_buf_out}."""
    D = len(shard_ops)
    wide_segs = []
    for ops in shard_ops:
        w = np.sort(ops[ops > W])[::-1]
        wide_segs.append(-(-w // W))
    r_wides = [int(s.sum()) for s in wide_segs]
    r_wide_max = max(r_wides + [0])
    if r_wide_max == 0:
        return 0, np.zeros((D, 1), np.int32), []
    wide_rid = np.full((D, r_wide_max), -1, np.int32)
    for d, segs in enumerate(wide_segs):
        if len(segs):
            wide_rid[d, : int(segs.sum())] = np.repeat(
                np.arange(len(segs)), segs)

    # per-shard absolute level schedules
    per_shard: List[List[dict]] = []
    depth = 0
    for segs in wide_segs:
        rows = []
        base = 0
        for rid, s in enumerate(segs):
            rows.append((rid, list(range(base, base + int(s)))))
            base += int(s)
        levels = []
        W_in = W
        while rows:
            f_eff = min(F, max(max_width // W_in, 2))
            in_map, final, nxt = [], [], []
            out_base = 0
            for rid, segids in rows:
                n_out = -(-len(segids) // f_eff)
                outs = []
                for o in range(n_out):
                    grp = segids[o * f_eff: (o + 1) * f_eff]
                    in_map.append(grp + [-1] * (f_eff - len(grp)))
                    final.append(n_out == 1)
                    outs.append(out_base)
                    out_base += 1
                if n_out > 1:
                    nxt.append((rid, outs))
            levels.append(dict(F=f_eff, W_in=W_in,
                               in_map=np.asarray(in_map, np.int32),
                               final=np.asarray(final, bool)))
            rows = nxt
            W_in *= f_eff
        per_shard.append(levels)
        depth = max(depth, len(levels))

    # pad across shards to one common schedule (F/W_in agree by
    # construction: both derive only from W and the level index)
    cap = _pow2ceil(n_cols) if n_cols else None
    specs = []
    W_in = W
    w_buf = W if cap is None else min(W, cap)
    for li in range(depth):
        f_eff = min(F, max(max_width // W_in, 2))
        R_out = max((lv[li]["in_map"].shape[0]
                     for lv in per_shard if li < len(lv)), default=1)
        R_out = max(R_out, 1)
        im = np.full((D, R_out, f_eff), -1, np.int32)
        fm = np.zeros((D, R_out), bool)
        for d, lv in enumerate(per_shard):
            if li < len(lv):
                k = lv[li]["in_map"].shape[0]
                im[d, :k] = lv[li]["in_map"]
                fm[d, :k] = lv[li]["final"]
        w_out = f_eff * w_buf if cap is None else min(cap, f_eff * w_buf)
        specs.append(dict(F=f_eff, W_in=W_in, R_out=R_out,
                          in_map=im, final=fm,
                          W_buf_in=w_buf, W_buf_out=w_out))
        W_in *= f_eff
        w_buf = w_out
    return r_wide_max, wide_rid, specs


def _host_row_ops(a: HostCSR, b_len: np.ndarray) -> np.ndarray:
    """Products per row of A·B: B's row lengths summed over each A row,
    by an int64 cumulative-sum difference at the row bounds (the
    reference's ``np.add.at``, without its per-element cost)."""
    cse = np.zeros(a.nnz + 1, np.int64)
    np.cumsum(np.asarray(b_len, np.int64)[np.asarray(a.col_ids, np.int64)],
              out=cse[1:])
    ip = np.asarray(a.row_offsets, np.int64)
    return cse[ip[1:]] - cse[ip[:-1]]


# ---------------------------------------------------------------------------
# Pre-sharded inputs: a process needs only its own row shards' payloads.
# Everything cross-shard the host planner consumes is per-shard metadata
# combined across processes as small padded arrays.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowShards:
    """A row-sharded matrix for ``mesh_stream_spgemm``: shape (m, n),
    rows dealt in contiguous blocks over D shards — equal ceil(m/D)
    counts by default, or explicit ``ranges_`` (the ops-balanced A
    partition, ``balanced_row_ranges``). This process holds the HostCSR
    row slices of the shards it runs (all of them under a single
    controller).

    ``local``: dict shard-index -> HostCSR (rows == that shard's row
    count, offsets rebased to the slice)."""

    m: int
    n: int
    D: int
    local: dict
    ranges_: Optional[list] = None

    @property
    def ranges(self):
        if self.ranges_ is not None:
            return self.ranges_
        m_loc = max(1, -(-self.m // self.D))
        return [(min(d * m_loc, self.m), min((d + 1) * m_loc, self.m))
                for d in range(self.D)]

    @classmethod
    def from_global(cls, a: HostCSR, D: int,
                    ranges: Optional[list] = None) -> "RowShards":
        sh = cls(m=a.rows, n=a.cols, D=D, local={},
                 ranges_=(list(ranges) if ranges is not None else None))
        sh.local = {d: _slice_rows(a, r0, r1)
                    for d, (r0, r1) in enumerate(sh.ranges)}
        return sh

    @classmethod
    def from_local(cls, m: int, n: int, D: int,
                   local: dict) -> "RowShards":
        """Multi-process constructor: ``local`` holds only the shards
        this process runs."""
        return cls(m=m, n=n, D=D, local=dict(local))

    @property
    def all_local(self) -> bool:
        return len(self.local) == self.D


def _tight_weights(row_ops: np.ndarray, W: int, min_q: int) -> np.ndarray:
    """Per-row stream allocation under the tight layout
    (ops/stream._tight_layout): wide rows take exact W-multiples,
    mid-size rows (q > W/8) their pow2 quantum, small rows max(ops,
    min_q)."""
    ops = np.asarray(row_ops, np.int64)
    qe = np.maximum(ops, min_q)
    return np.where(ops > W, (-(-ops // W)) * W,
                    np.where(qe > W // 8, _pow2ceil_arr(qe), qe))


def balanced_row_ranges(row_ops: np.ndarray, D: int, min_q: int = 8,
                        W: int = 8192) -> list:
    """Contiguous shard boundaries equalizing cumulative per-row stream
    allocation (the tight layout's quantized weight, _tight_weights)
    instead of row counts. O(m) host work."""
    w = _tight_weights(row_ops, W, min_q)
    m = w.shape[0]
    if m == 0:
        return [(0, 0)] * D
    c = np.cumsum(w)
    total = int(c[-1])
    bounds = np.searchsorted(c, [total * d // D for d in range(1, D)],
                             side="left")
    bounds = np.concatenate([[0], np.minimum(bounds + 1, m), [m]])
    bounds = np.maximum.accumulate(bounds)
    return [(int(bounds[d]), int(bounds[d + 1])) for d in range(D)]


def _owner_of(r: int, ranges) -> int:
    """Owner shard of global row r under contiguous ranges."""
    for d, (r0, r1) in enumerate(ranges):
        if r0 <= r < r1:
            return d
    raise ValueError(f"row {r} outside sharded ranges {ranges}")


def _combine_max(x: np.ndarray) -> np.ndarray:
    """Elementwise max across processes (identity under one controller).
    Per-shard metadata is zero-filled where non-local, so max recovers
    the owner's values everywhere."""
    if process_count() == 1:
        return x
    return np.max(_host_all_gather(np.asarray(x)), axis=0)


def _combine_sum(x: np.ndarray) -> np.ndarray:
    """Elementwise sum across processes of owner-exclusive, zero-filled
    data (identity under one controller)."""
    if process_count() == 1:
        return x
    return np.sum(_host_all_gather(np.asarray(x)), axis=0)


def _stack_shards(ash: RowShards, np_dtype=np.float32):
    """Per-shard padded (D, m_loc+1) indptr / (D, nnz_max) cols / data,
    zero-filled for non-local shards. m_loc is the LARGEST shard's row
    count (ranges may be ops-balanced); nnz_max is agreed across
    processes via one combine."""
    D = ash.D
    m_loc = max([1] + [r1 - r0 for r0, r1 in ash.ranges])
    nnz_loc = np.zeros(D, np.int64)
    for d, sl in ash.local.items():
        nnz_loc[d] = sl.nnz
    nnz_loc = _combine_max(nnz_loc)
    nnz_max = max(1, int(nnz_loc.max(initial=0)))
    ai = np.zeros((D, m_loc + 1), np.int32)
    ax = np.zeros((D, nnz_max), np.int32)
    ad = np.zeros((D, nnz_max), np_dtype)
    for d, sl in ash.local.items():
        ai[d] = _pad_to(np.asarray(sl.row_offsets, np.int32), m_loc + 1,
                        fill=int(sl.nnz))
        ax[d, : sl.nnz] = np.asarray(sl.col_ids, np.int32)
        ad[d, : sl.nnz] = np.asarray(sl.data, np_dtype)
    return ai, ax, ad, ash.ranges


def _shard_row_lens(bsh: RowShards) -> np.ndarray:
    """Global B row lengths: per-shard diffs, combined."""
    D = bsh.D
    k_loc = max(1, -(-bsh.m // D))
    lens = np.zeros((D, k_loc), np.int64)
    for d, sl in bsh.local.items():
        ln = np.diff(np.asarray(sl.row_offsets, np.int64))
        lens[d, : ln.shape[0]] = ln
    return _combine_max(lens).reshape(-1)[: bsh.m]


def _drop_rows(sl: HostCSR, local_ids: np.ndarray) -> HostCSR:
    """Copy of a local shard with the given local rows emptied."""
    ip = np.asarray(sl.row_offsets, np.int64)
    drop = np.zeros(sl.nnz, bool)
    for r in local_ids:
        drop[ip[r]: ip[r + 1]] = True
    lens = ip[1:] - ip[:-1]
    lens2 = lens.copy()
    lens2[local_ids] = 0
    ip2 = np.zeros(sl.rows + 1, np.int64)
    np.cumsum(lens2, out=ip2[1:])
    keep = ~drop
    return HostCSR(rows=sl.rows, cols=sl.cols, row_offsets=ip2,
                   col_ids=np.asarray(sl.col_ids)[keep],
                   data=np.asarray(sl.data)[keep])


@dataclasses.dataclass
class NeedsetStats:
    """Communication-volume accounting for the need-set exchange."""

    allgather_bytes: int   # (col, val) bytes every shard receives via all_gather
    needset_bytes: int     # padded (col, val) bytes exchanged per shard
    pairs_nnz: np.ndarray  # (D, D) true nnz needed dst<-src
    # executed exchange: "needset", or "allgather(auto)" when the auto
    # gate fell back because the padded plan would move more bytes than
    # replication
    mode: str = "needset"

    @property
    def zero_comm(self) -> bool:
        """True when no bytes cross the interconnect at all (pure
        block-diagonal need: every non-self round empty)."""
        return self.needset_bytes == 0

    @property
    def reduction(self) -> float:
        if self.needset_bytes == 0:
            return float("inf")
        return self.allgather_bytes / self.needset_bytes


# ---------------------------------------------------------------------------
# Device-side need-set planning
#
# Per dst shard, a need BITMAP over the (padded) B rows its A columns (and
# k-split slots) reference; the only host readback is the D^2 per-pair
# row and record counts (the round padding's static shapes). Every table
# the exchange needs — the received-buffer slot map, the A-column remap
# and the per-round send gather plans — is derived on the devices from
# the bitmaps; a send plan needs the dst's bitmap row at the src, which
# moves by one ppermute per round.
# ---------------------------------------------------------------------------


def _needset_bitmap(ax, nnz_d: int, spl, spl_n: int, b_len_pad, *, D: int,
                    k_loc: int):
    """Phase A, one dst shard: need (D, k_loc) bool over (src shard, B
    row) and the (2, D) [needed rows, needed records] per src."""
    dev = ax.device
    b_rows_pad = D * k_loc
    need = torch.zeros(b_rows_pad + 1, dtype=torch.bool, device=dev)
    # the value set is a tensor on the device: a Python scalar there would
    # be copied from the host, and the host would wait for the card
    true = need.new_ones(())
    valid = torch.arange(ax.shape[0], dtype=I32, device=dev) < nnz_d
    need[torch.where(valid, ax, b_rows_pad)] = true
    vs = torch.arange(spl.shape[0], dtype=I32, device=dev) < spl_n
    need[torch.where(vs, spl, b_rows_pad)] = true
    need = need[:b_rows_pad].reshape(D, k_loc)
    rows_cnt = torch.sum(need, dim=1, dtype=I32)
    nnz_cnt = torch.sum(torch.where(need, b_len_pad.reshape(D, k_loc), 0),
                        dim=1, dtype=I32)
    return need, torch.stack([rows_cnt, nnz_cnt])


def _needset_recv_tables(need, b_len_pad, seg_off_by_r, d: int, *, D: int,
                         k_loc: int, P_rows: int):
    """Phase B1 (dst side), shard d: received-buffer row tables and the
    column LUT. The needed rows of src's block occupy received-buffer
    slots src*P_rows + rank; their records land at seg_off[(d-src)%D] +
    running offset. Returns (rb_start (D*P_rows,), rb_len (D*P_rows,),
    lut (D*k_loc,) received slot of every B row, 0 where not needed)."""
    dev = need.device
    RB = D * P_rows
    lens_n = torch.where(need, b_len_pad.reshape(D, k_loc), 0)
    needi = need.to(I32)
    rank = torch.cumsum(needi, 1, dtype=I32) - needi
    start_in_pair = torch.cumsum(lens_n, 1, dtype=I32) - lens_n
    src_ids = torch.arange(D, dtype=I32, device=dev)
    slot = src_ids[:, None] * P_rows + rank
    base = seg_off_by_r[(d - src_ids) % D][:, None]
    tgt = torch.where(need, slot, RB).reshape(-1)

    def scat(vals):
        out = torch.zeros(RB + 1, dtype=I32, device=dev)
        out[tgt] = vals.reshape(-1).to(I32)
        return out[:RB]

    rb_start = scat(base + start_in_pair)
    rb_len = scat(lens_n)
    q = torch.arange(D * k_loc, dtype=I32, device=dev).reshape(D, k_loc)
    row_tgt = torch.where(need, q, D * k_loc).reshape(-1)
    lut = torch.zeros(D * k_loc + 1, dtype=I32, device=dev)
    lut[row_tgt] = torch.where(need, slot, 0).reshape(-1)
    return rb_start, rb_len, lut[: D * k_loc]


def _needset_send_plan(blk, lens, *, Rr: int):
    """Phase B2 (src side), one round at one src shard: the gather plan of
    the B records dst = (src + r) % D needs. ``blk`` (k_loc,) is that
    dst's need row over this src's block, ``lens`` this block's B row
    lengths. Returns (send_idx (Rr,) src-local record positions,
    send_valid (Rr,))."""
    dev = blk.device
    lens_n = torch.where(blk, lens, 0)
    starts = torch.cumsum(lens_n, 0, dtype=I32) - lens_n
    total = torch.sum(lens_n, dtype=I32)
    live = blk & (lens > 0)
    livei = live.to(I32)
    rank = torch.cumsum(livei, 0, dtype=I32) - livei
    tgt = torch.where(live, rank, Rr)
    loc_base = torch.cumsum(lens, 0, dtype=I32) - lens

    def compact(vals):
        out = torch.zeros(Rr + 1, dtype=I32, device=dev)
        out[tgt] = vals.to(I32)
        return out[:Rr]

    starts_c = compact(starts)
    base_c = compact(loc_base)
    # run-length decode: segment id of each payload position (the live
    # starts are distinct, so a set marks them)
    marks = torch.zeros(Rr + 1, dtype=I32, device=dev)
    marks[torch.where(live, starts, Rr)] = marks.new_ones(())
    seg = torch.cumsum(marks[:Rr], 0, dtype=I32) - 1
    segc = torch.clamp(seg, 0, Rr - 1)
    i = torch.arange(Rr, dtype=I32, device=dev)
    idx = base_c[segc] + (i - starts_c[segc])
    valid = i < total
    return torch.where(valid, idx, 0), valid


def _plan_needset_device(mesh: RowMesh, ax, nnz_d_h, spl_cols, spl_nnz_h,
                         b_len_h, D: int, k_loc: int,
                         pad_exact: bool = True):
    """Run phases A and B: the plan products of the host planner — pair
    counts (D, D) on the host, the round sizes, and per-shard rb_start,
    rb_len, lut and the per-round send plans. The ONLY host readback is
    the D^2 pair counts (``fetch_global``: one per process)."""
    b_len_pad = np.zeros(D * k_loc, np.int32)
    b_len_pad[: b_len_h.shape[0]] = b_len_h
    blp = {d: upload(b_len_pad, mesh.devices[d]) for d in mesh.local}
    need, cnts = {}, {}
    for d in mesh.local:
        spl = (spl_cols[d] if spl_cols is not None
               else torch.zeros(1, dtype=I32, device=mesh.devices[d]))
        spl_n = int(spl_nnz_h[d]) if spl_nnz_h is not None else 0
        need[d], cnts[d] = _needset_bitmap(
            ax[d], int(nnz_d_h[d]), spl, spl_n, blp[d], D=D, k_loc=k_loc)
    counts = fetch_global(mesh, cnts)                   # (D, 2, D)
    rows_cnt_h = counts[:, 0].astype(np.int64)
    pair_nnz = counts[:, 1].astype(np.int64)
    P_rows = int(_pow2ceil(max(1, int(rows_cnt_h.max(initial=1)))))
    round_nnz = []
    for r in range(D):
        mx = max(int(pair_nnz[(s + r) % D, s]) for s in range(D))
        round_nnz.append((mx if pad_exact else int(_pow2ceil(mx)))
                         if mx > 0 else 0)
    seg_off = np.concatenate([[0], np.cumsum(round_nnz)]).astype(np.int64)
    if seg_off[-1] >= 2 ** 31:
        raise ValueError(
            f"need-set exchange would stage {int(seg_off[-1])} B records "
            "per shard, past the 2^31 int32 ceiling; use more shards")
    rb_start, rb_len, lut = {}, {}, {}
    for d in mesh.local:
        so = upload(seg_off[:-1].astype(np.int32), mesh.devices[d])
        rb_start[d], rb_len[d], lut[d] = _needset_recv_tables(
            need[d], blp[d], so, d, D=D, k_loc=k_loc, P_rows=P_rows)

    def send_plans():
        out = []
        for r in range(D):
            if round_nnz[r] == 0:
                continue
            # src s needs need[(s + r) % D][s]: shard t sends its row for
            # src (t - r) % D there
            rows = ppermute(mesh, {t: need[t][(t - r) % D]
                                   for t in mesh.local}, -r)
            si, sv = {}, {}
            for s in mesh.local:
                si[s], sv[s] = _needset_send_plan(
                    rows[s], blp[s][s * k_loc:(s + 1) * k_loc],
                    Rr=round_nnz[r])
            out.append((si, sv))
        return out

    return dict(pair_nnz=pair_nnz, round_nnz=round_nnz, seg_off=seg_off,
                P_rows=P_rows, rb_start=rb_start, rb_len=rb_len, lut=lut,
                send_plans=send_plans)


def _lut_gather(lut, idx):
    """Per-shard LUT remap: out[d][i] = lut[d][idx[d][i]]."""
    return {d: lut[d][torch.clamp(idx[d], 0, lut[d].shape[0] - 1)]
            for d in idx}


# at most this many rows take the k-split path per call (bounds the
# padded host-exchange arrays); excess candidates DEGRADE to the
# per-shard wide-row ladder instead of raising (rows past the int32
# stream ceiling always split and are never dropped)
_KSPLIT_MAX_ROWS = 64


def _plan_ksplit_shards(ash: RowShards, ops_sh: np.ndarray,
                        b_len_h: np.ndarray, D: int, k_locB: int,
                        split_min: int, subrow_max: int = 1 << 30,
                        np_dtype=np.float32, owned=None):
    """Host plan for k-split rows (single-row sharding): rows with more
    products than ``split_min`` (and ALWAYS rows a single shard cannot
    hold) are removed from their owner shard's local A and their
    nonzeros re-dealt BY B-ROW-OWNER: shard s gets the slots whose a_col
    lies in its B shard, so the partial products need no remote B rows
    at all (needset: pure self-need). Partials merge via one all_gather
    and a sort (``_ksplit_merge``).

    Degrade paths: more than _KSPLIT_MAX_ROWS candidates: only the
    heaviest 64 (plus every must-split row) take this path, the rest ride
    the ladder; a sub-row past ``subrow_max`` products on one shard
    splits again into consecutive slot parts, each its own pipeline row,
    all merged in the owner's one sort.

    ``ops_sh`` (D, m_loc): per-shard row ops (globally combined).
    ``owned``: the shards this process runs; only they contribute the
    split rows' slots to the cross-process sum (a process holding the
    whole matrix would otherwise add every row once per process).
    Returns (ash_eff, ops_sh_eff, ksp|None) where ash_eff has the split
    rows emptied in their owner shards."""
    subrow_max = min(subrow_max, 1 << 30)
    # a row no single shard can ladder must split regardless of knobs
    must_min = 1 << 30
    split_min = min(split_min, must_min)
    ranges = ash.ranges
    hits = ops_sh > split_min                     # (D, m_loc), global info
    n_split = int(hits.sum())
    if n_split == 0:
        return ash, ops_sh, None
    d_ids, j_ids = np.nonzero(hits)
    cand = np.array(
        [(ranges[d][0] + j, ops_sh[d, j])
         for d, j in zip(d_ids, j_ids)], np.int64)
    if n_split > _KSPLIT_MAX_ROWS:
        must = cand[cand[:, 1] > must_min]
        opt = cand[cand[:, 1] <= must_min]
        room = max(_KSPLIT_MAX_ROWS - must.shape[0], 0)
        # heaviest first; deterministic tie-break on row id
        order = np.lexsort((opt[:, 0], -opt[:, 1]))
        cand = np.concatenate([must, opt[order[:room]]])
        n_split = cand.shape[0]
        if n_split == 0:
            return ash, ops_sh, None
    split_ids = np.sort(cand[:, 0])
    # exchange the split rows' slot payloads: owner fills, others zero
    lens = np.zeros(n_split, np.int64)
    for j, r in enumerate(split_ids):
        d = _owner_of(int(r), ranges)
        if d in ash.local:
            ip = np.asarray(ash.local[d].row_offsets, np.int64)
            lr = int(r) - ranges[d][0]
            lens[j] = ip[lr + 1] - ip[lr]
    lens = _combine_max(lens)
    L = max(1, int(lens.max(initial=1)))
    scols = np.zeros((n_split, L), np.int64)
    svals = np.zeros((n_split, L), np.float64)
    for j, r in enumerate(split_ids):
        d = _owner_of(int(r), ranges)
        if d in ash.local and (owned is None or d in owned):
            sl = ash.local[d]
            ip = np.asarray(sl.row_offsets, np.int64)
            lr = int(r) - ranges[d][0]
            o0, o1 = int(ip[lr]), int(ip[lr + 1])
            scols[j, : o1 - o0] = np.asarray(sl.col_ids[o0:o1], np.int64)
            svals[j, : o1 - o0] = np.asarray(sl.data[o0:o1])
    # owner-exclusive zero-filled data: sum-combine recovers it everywhere
    scols = _combine_sum(scols)
    svals = _combine_sum(svals)
    # drop the split rows from their owner shards + zero their ops
    ash_eff = RowShards(m=ash.m, n=ash.n, D=D, local=dict(ash.local),
                        ranges_=ash.ranges_)
    ops_eff = ops_sh.copy()
    for j, r in enumerate(split_ids):
        d = _owner_of(int(r), ranges)
        ops_eff[d, int(r) - ranges[d][0]] = 0
        if d in ash_eff.local:
            ash_eff.local[d] = _drop_rows(
                ash_eff.local[d],
                np.array([int(r) - ranges[d][0]]))
    # per-shard sub-CSR: split row j's slots whose col is owned by B
    # shard s, secondary-split into max_parts consecutive part-rows of
    # <= subrow_max products each (part p of row j = pipeline row
    # j * max_parts + p; empty parts contribute nothing)
    sub_cols = [[None] * n_split for _ in range(D)]
    sub_vals = [[None] * n_split for _ in range(D)]
    sub_parts = np.ones((D, n_split), np.int64)
    for j in range(n_split):
        cj = scols[j, : lens[j]]
        vj = svals[j, : lens[j]]
        own = cj // k_locB
        for s in range(D):
            sel = own == s
            cs, vs = cj[sel], vj[sel]
            sub_cols[s][j] = cs
            sub_vals[s][j] = vs
            ops_slots = b_len_h[cs]
            if int(ops_slots.max(initial=0)) > subrow_max:
                raise ValueError(
                    f"one B row has {int(ops_slots.max())} nonzeros, "
                    f"past the per-part ceiling {subrow_max}; cannot "
                    "split below one (A-slot, B-row) product block")
            if int(ops_slots.sum()) > subrow_max:
                # greedy consecutive grouping under the ceiling
                acc, parts = 0, 1
                for o in ops_slots:
                    if acc + int(o) > subrow_max:
                        parts += 1
                        acc = int(o)
                    else:
                        acc += int(o)
                sub_parts[s, j] = parts
    max_parts = int(sub_parts.max(initial=1))
    n_rows = n_split * max_parts
    # part slot slices + per-part ops
    sub_ops = np.zeros((D, n_rows), np.int64)
    part_slice = {}
    for s in range(D):
        for j in range(n_split):
            ops_slots = b_len_h[sub_cols[s][j]]
            cuts = [0]
            acc = 0
            for i, o in enumerate(ops_slots):
                if acc + int(o) > subrow_max and acc > 0:
                    cuts.append(i)
                    acc = int(o)
                else:
                    acc += int(o)
            cuts.append(len(ops_slots))
            for p in range(len(cuts) - 1):
                lo, hi = cuts[p], cuts[p + 1]
                part_slice[(s, j, p)] = (lo, hi)
                sub_ops[s, j * max_parts + p] = int(
                    ops_slots[lo:hi].sum())
    assert sub_ops.max(initial=0) <= subrow_max
    spl_cap = max(1, max(
        sum(len(c) for c in sub_cols[s]) for s in range(D)))
    spl_indptr = np.zeros((D, n_rows + 1), np.int64)
    spl_cols = np.zeros((D, spl_cap), np.int64)
    spl_vals = np.zeros((D, spl_cap), np_dtype)
    for s in range(D):
        off = 0
        for j in range(n_split):
            for p in range(max_parts):
                if (s, j, p) in part_slice:
                    lo, hi = part_slice[(s, j, p)]
                    c = sub_cols[s][j][lo:hi]
                    spl_cols[s, off: off + len(c)] = c
                    spl_vals[s, off: off + len(c)] = \
                        sub_vals[s][j][lo:hi]
                    off += len(c)
                spl_indptr[s, j * max_parts + p + 1] = off
    ksp = dict(split_ids=split_ids, n_split=n_split, n_rows=n_rows,
               max_parts=max_parts, spl_indptr=spl_indptr,
               spl_cols=spl_cols, spl_vals=spl_vals, sub_ops=sub_ops,
               spl_cap=spl_cap)
    return ash_eff, ops_eff, ksp


# ---------------------------------------------------------------------------
# The per-shard stream pipeline
# ---------------------------------------------------------------------------


def _operands(b_payload, ad, sa, src, f64: bool):
    """The expand stage's record channel and B operand: float32 takes the
    packed (col, value bits) records with A's value bits; float64 the
    unpacked columns and values of the (col, lo, hi) records with the
    A-source map (``ops.expand.Unpacked``)."""
    if f64:
        b_ind = b_payload[:, 0].contiguous()
        # a fresh copy: with 0 or 1 rows the slice is already contiguous,
        # at storage offset 1, and would not view as float64
        b_dat = b_payload[:, 1:3].clone(
            memory_format=torch.contiguous_format).view(
                torch.float64).reshape(-1)
        return src, Unpacked(ad, b_ind, b_dat)
    return sa, b_payload


def _stream_pipeline(cfg, G: int, W: int, n_cols: int, ai, ax, ad,
                     b_start, b_len, b_payload, wide_rid, level_args,
                     specs, *, m: int, n_ch: int, rw_max: int,
                     row_mask=None, f64: bool = False, emit_to=None):
    """One stream pipeline over one shard's local CSR: plan, chunks, the
    wide-row ladder. ``row_mask`` (m,) restricts it to a subset of rows
    (their products forced to 0 elsewhere): the overlapped exchange runs
    one pipeline a round group.

    Retained memory is bounded: ladder levels with no final row retain
    nothing; when the staged-chunk set would exceed
    ``cfg.fused_staging_budget`` (3 int32 planes per slot), only chunks
    holding wide-row segments stage and the rest count only and re-expand
    in the emission pass (``stream_chunk_numeric``); with
    ``emit_to=(offsets, cols, vals)`` (static offsets, the k-split partial
    buffers, each with a trailing drop slot) every chunk and level emits
    at once and the return is (nnz_row, cols, vals).

    Without emit_to, returns (nnz_row, rows_sorted, staged, level_out,
    rec, n_wide): nnz_row has a trailing drop slot; staged entries are
    None for unstaged chunks, which _emit_pipeline re-expands from the
    chunks' records ``rec``; n_wide is the wide rows' count (a device
    scalar)."""
    dev = ai.device
    CP = G * W
    zero1 = torch.zeros(1, dtype=I32, device=dev)
    blen_a = b_len[ax]
    cse = torch.cat([zero1, cumsum1d(blen_a)])
    row_ops = cse[ai[1:]] - cse[ai[:-1]]
    if row_mask is not None:
        row_ops = torch.where(row_mask, row_ops, 0)
    stream_mask = row_ops > 0
    no_direct = torch.zeros(m, dtype=torch.bool, device=dev)
    a32 = (torch.zeros(ad.shape, dtype=I32, device=dev) if f64
           else ad.contiguous().view(I32))
    (rows_sorted, e, q_sorted, el, ops_sorted) = _plan_rows_impl(
        row_ops, stream_mask, no_direct, min_q=cfg.stream_min_q, m=m,
        w_fixed=W)[:5]
    p0, su, sa, src, pend = build_srec(ai, ax, a32, b_start, b_len,
                                       rows_sorted, e, q_sorted, m=m)
    sa_ch, b_rec = _operands(b_payload, ad, sa, src, f64)
    sid = torch.searchsorted(p0, torch.arange(n_ch, dtype=I32, device=dev)
                             * CP, out_int32=True)
    rec = ChunkRecords(e, p0, su, sa_ch, src, pend, b_rec, sid, G=G,
                       g_last=G, W=W, n_chunks=n_ch, n_cols=n_cols,
                       pack_bits=0)
    nnz_row = torch.zeros(m + 1, dtype=I32, device=dev)
    n_wide_dev = torch.sum(q_sorted > W, dtype=I32)
    fused = 3 * n_ch * CP <= cfg.fused_staging_budget
    if emit_to is not None:
        offs_e, cols_e, vals_e = emit_to
    staged = []
    for c in range(n_ch):
        # wide-row segments live in the first rw_max rectangle rows
        # (descending sort); only those chunks must stage for the ladder
        has_wide = c * G < rw_max
        do_stage = emit_to is not None or fused or has_wide
        nnz_row, stg = stream_chunk(rec, c, rows_sorted, q_sorted, el,
                                    ops_sorted, nnz_row, stage=do_stage)
        if emit_to is not None and not has_wide:
            cols_e, vals_e = stream_emit(rows_sorted, *stg, offs_e, cols_e,
                                         vals_e, min_rid=n_wide_dev)
            stg = None
        staged.append(stg if do_stage else None)
    level_out = []
    if rw_max > 0 and specs:
        rid_in = wide_rid
        wb0 = specs[0]["W_buf_in"]
        wst = [s for s in staged[: -(-rw_max // G)] if s is not None]
        # compacted segments hold <= min(W, n_cols) live entries, so the
        # column truncation to the capped buffer width is lossless
        wcol = torch.cat([s[1] for s in wst])[:rw_max, :wb0]
        wval = torch.cat([s[2] for s in wst])[:rw_max, :wb0]
        wcnt = torch.cat([s[3] for s in wst])[:rw_max]
        wcnt = torch.where(rid_in >= 0, wcnt, 0)
        if emit_to is not None:
            # wide chunks were retained only for the ladder; their
            # contained rows still need emission
            for stg in wst:
                cols_e, vals_e = stream_emit(rows_sorted, *stg, offs_e,
                                             cols_e, vals_e,
                                             min_rid=n_wide_dev)
        for li, spec in enumerate(specs):
            in_map = level_args[2 * li]
            final = level_args[2 * li + 1]
            nnz_row, (rid_out, col_c, val_c, counts) = stream_level(
                rows_sorted, rid_in, wcol.contiguous(), wval.contiguous(),
                wcnt, in_map, final, nnz_row, F=spec["F"],
                W_in=spec["W_buf_in"], n_cols=n_cols, count=True,
                compact_impl=cfg.stream_compact_impl)
            if spec["W_buf_out"] < col_c.shape[1]:
                col_c = col_c[:, : spec["W_buf_out"]]
                val_c = val_c[:, : spec["W_buf_out"]]
            if bool(np.asarray(spec["final"]).any()):
                fcnt = torch.where(final, counts, 0)
                rid_b = rid_out[:, None].expand(col_c.shape)
                if emit_to is not None:
                    cols_e, vals_e = stream_emit(
                        rows_sorted, rid_b, col_c, val_c, fcnt, offs_e,
                        cols_e, vals_e)
                else:
                    level_out.append((rid_b, col_c, val_c, fcnt))
            rid_in, wcol, wval, wcnt = rid_out, col_c, val_c, counts
    if emit_to is not None:
        return nnz_row, cols_e, vals_e
    return nnz_row, rows_sorted, staged, level_out, rec, n_wide_dev


def _emit_pipeline(pipe, offs, c_cols, c_vals):
    """Emission pass for one _stream_pipeline result: staged chunks
    scatter their compacted contained rows (stream_emit); unstaged chunks
    (two-phase staging) re-expand straight into C (stream_chunk_numeric:
    per-chunk transients only); retained ladder levels emit their final
    rows."""
    _, rows_sorted, staged, level_out, rec, n_wide = pipe
    for c, stg in enumerate(staged):
        if stg is not None:
            c_cols, c_vals = stream_emit(rows_sorted, *stg, offs, c_cols,
                                         c_vals, min_rid=n_wide)
        else:
            c_cols, c_vals, _ = stream_chunk_numeric(
                rec, c, rows_sorted, offs, c_cols, c_vals, n_wide,
                stage_wide=False)
    for rid_b, col_c, val_c, fcnt in level_out:
        c_cols, c_vals = stream_emit(rows_sorted, rid_b, col_c, val_c, fcnt,
                                     offs, c_cols, c_vals)
    return c_cols, c_vals


def _ksplit_merge(g_c, g_v, spl_tgt, nnz_row, *, n_split: int, Wm: int,
                  n_cols: int, compact_impl: str = "sort"):
    """Merge the gathered k-split partial rows (D, n_split, PM) with ONE
    sort and contract (all of a row's part-rows across all shards land in
    its Wm-wide merge row); the owner takes the counts (``spl_tgt``: the
    local row, the drop slot elsewhere). Returns (nnz_row, (col_m, val_m,
    cnt_m))."""
    D_ax, _, PM = g_c.shape
    mc = g_c.permute(1, 0, 2).reshape(n_split, D_ax * PM)
    mv = g_v.permute(1, 0, 2).reshape(n_split, D_ax * PM)
    if Wm > D_ax * PM:
        pad = Wm - D_ax * PM
        mc = torch.cat([mc, torch.full((n_split, pad), n_cols, dtype=I32,
                                       device=mc.device)], dim=1)
        mv = torch.cat([mv, torch.zeros((n_split, pad), dtype=mv.dtype,
                                        device=mv.device)], dim=1)
    col_s, val_s = _sort_cols(mc.contiguous(), mv.contiguous())
    rid_bm = torch.arange(n_split, dtype=I32,
                          device=mc.device)[:, None].expand(n_split, Wm)
    last, run_sum = stream_contract(rid_bm, col_s, val_s, n_cols)
    _, col_m, val_m, cnt_m = _compact_rect(last, None, col_s, run_sum,
                                           compact_impl)
    nnz_row[spl_tgt] = cnt_m
    return nnz_row, (col_m, val_m, cnt_m)


class _ShardBody:
    """The per-shard stream pipeline: analysis, planning, chunked
    count+stage, the wide-row merge ladder (host-planned in_maps arrive as
    per-shard arguments), the k-split partials and merge, device offsets,
    emission. W stays at the configured chunk width regardless of skew: a
    wide row owns whole rectangle rows and the ladder finishes it.

    ``groups``: the row groups, one pipeline each, as dicts of ``round``,
    ``n_chunks``, ``rw_max`` and ``specs``. The allgather and need-set
    steps run one group of every row; the overlapped exchange one group a
    live round, each over its rows (a row mask argument) and the received
    prefix of its round.

    ``run`` is the loop over the local shards that stands in for the
    reference's shard_map: cut at the k-split's all_gather, the one
    collective inside the body."""

    def __init__(self, cfg: SpgemmConfig, m_loc: int, W: int, G: int,
                 n_chunks: int, out_cap: int, n_cols: int,
                 r_wide_max: int = 0, level_specs=(), ks=None,
                 f64: bool = False, groups=None):
        self.cfg, self.m_loc, self.W, self.G = cfg, m_loc, W, G
        self.out_cap, self.n_cols = out_cap, n_cols
        self.ks, self.f64 = ks, f64
        self.val_dtype = torch.float64 if f64 else torch.float32
        self.masked = groups is not None
        self.groups = (list(groups) if self.masked else
                       [dict(round=None, n_chunks=n_chunks,
                             rw_max=r_wide_max, specs=list(level_specs))])

    def count(self, ai, ax, ad, b_start, b_len, b_payload, *extra):
        """Everything before the k-split's all_gather: the row groups'
        pipelines and the k-split partial rows (static offsets, row i at
        i*P). ``b_payload``: B's records, or a function of a round giving
        the received prefix that round's group reads (the k-split's slots
        read round 0's). ``extra``: a group's row mask (masked groups
        only), wide_rid and level maps, group by group, then the k-split's
        inputs."""
        payload = b_payload if callable(b_payload) else (lambda r: b_payload)
        pipes, i = [], 0
        for g in self.groups:
            mask = None
            if self.masked:
                mask, i = extra[i], i + 1
            n_lv = 2 * len(g["specs"])
            pipes.append(_stream_pipeline(
                self.cfg, self.G, self.W, self.n_cols, ai, ax, ad, b_start,
                b_len, payload(g["round"]), extra[i],
                extra[i + 1: i + 1 + n_lv], g["specs"], m=self.m_loc,
                n_ch=g["n_chunks"], rw_max=g["rw_max"], row_mask=mask,
                f64=self.f64))
            i += 1 + n_lv
        st = dict(pipes=pipes)
        ks = self.ks
        if ks is not None:
            rest = extra[i:]
            si, sx, sv, spl_tgt, spl_emit, spl_wrid = rest[:6]
            n_rows, P = ks["n_rows"], ks["P"]
            dev = ai.device
            offs_p = torch.arange(n_rows + 1, dtype=I32, device=dev) * P
            p_cols = torch.full((n_rows * P + 1,), self.n_cols, dtype=I32,
                                device=dev)
            p_vals = torch.zeros(n_rows * P + 1, dtype=self.val_dtype,
                                 device=dev)
            # k-split slots are self-owned: their records are in round 0
            _, p_cols, p_vals = _stream_pipeline(
                self.cfg, self.G, self.W, self.n_cols, si, sx, sv, b_start,
                b_len, payload(0), spl_wrid, rest[6:], ks["specs"],
                m=n_rows, n_ch=ks["n_chunks"], rw_max=ks["rw_max"],
                f64=self.f64, emit_to=(offs_p, p_cols, p_vals))
            st.update(p_cols=p_cols[: n_rows * P].reshape(ks["n_split"],
                                                           ks["PM"]),
                      p_vals=p_vals[: n_rows * P].reshape(ks["n_split"],
                                                           ks["PM"]),
                      spl_tgt=spl_tgt, spl_emit=spl_emit)
        return st

    def finish(self, st, g_c=None, g_v=None):
        """The k-split merge (given the gathered partials), offsets and
        emission. Returns (nnz_row (m_loc,), cols (out_cap,), vals
        (out_cap,))."""
        pipes = st["pipes"]
        # a row counts in its own group only (0 in every other)
        nnz_row = pipes[0][0]
        for pipe in pipes[1:]:
            nnz_row = nnz_row + pipe[0]
        merged = None
        if self.ks is not None:
            nnz_row, merged = _ksplit_merge(
                g_c, g_v, st["spl_tgt"], nnz_row, n_split=self.ks["n_split"],
                Wm=self.ks["Wm"], n_cols=self.n_cols,
                compact_impl=self.cfg.stream_compact_impl)
        dev = nnz_row.device
        m_loc, out_cap = self.m_loc, self.out_cap
        offs = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                          cumsum1d(nnz_row[:m_loc])])
        c_cols = torch.zeros(out_cap + 1, dtype=I32, device=dev)
        c_vals = torch.zeros(out_cap + 1, dtype=self.val_dtype, device=dev)
        for pipe in pipes:
            c_cols, c_vals = _emit_pipeline(pipe, offs, c_cols, c_vals)
        if merged is not None:
            col_m, val_m, cnt_m = merged
            rid_e = st["spl_emit"][:, None].expand(col_m.shape)
            ident = torch.arange(m_loc, dtype=I32, device=dev)
            c_cols, c_vals = stream_emit(ident, rid_e, col_m, val_m, cnt_m,
                                         offs, c_cols, c_vals)
        return nnz_row[:m_loc], c_cols[:out_cap], c_vals[:out_cap]

    def run(self, mesh: RowMesh, inputs):
        """The body over every local shard; ``inputs(d)`` gives shard d's
        arguments. Returns per-shard (nnz_row, cols, vals) dicts."""
        out = {}
        if self.ks is None:
            # no collective inside: each shard runs to its end in turn,
            # so one shard's working set is live at a time
            for d in mesh.local:
                out[d] = self.finish(self.count(*inputs(d)))
        else:
            sts = {d: self.count(*inputs(d)) for d in mesh.local}
            g_c = all_gather(mesh, {d: sts[d].pop("p_cols") for d in sts})
            g_v = all_gather(mesh, {d: sts[d].pop("p_vals") for d in sts})
            for d in mesh.local:
                out[d] = self.finish(sts.pop(d), g_c[d], g_v[d])
        return ({d: o[0] for d, o in out.items()},
                {d: o[1] for d, o in out.items()},
                {d: o[2] for d, o in out.items()})


# ---------------------------------------------------------------------------
# The routing gates of the mesh diagonal-plane and dense routes
# ---------------------------------------------------------------------------


def _mesh_sdia_gate(ash: RowShards, bsh: RowShards, cfg: SpgemmConfig,
                    total_ops: float, D: int):
    """Host eligibility for the mesh DIA route, from per-shard local
    metadata only (extremes and the offset bitmaps combine across
    processes). Mirrors the single-device gates: square same-sharding
    operands, band range within sdia_span_cap, nd_a*nd_b within
    sdia_pair_cap, work within dia_waste_cap of the true product count,
    halo from ring neighbors only. Returns dict(off_a, off_b, dmin_a,
    dmin_b) or None."""
    if not cfg.enable_sdia:
        return None
    m, k = ash.m, bsh.m
    if m != k or ash.ranges_ is not None or bsh.ranges_ is not None:
        return None            # square, equal-count sharding only
    m_loc = max(1, -(-m // D))

    def extremes(sh):
        lo = np.full(1, np.iinfo(np.int64).max, np.int64)
        hi = np.full(1, np.iinfo(np.int64).min, np.int64)
        for d, sl in sh.local.items():
            ip = np.asarray(sl.row_offsets, np.int64)
            ln = ip[1:] - ip[:-1]
            ne = ln > 0
            if not ne.any():
                continue
            r0 = sh.ranges[d][0]
            rid = np.arange(sl.rows, dtype=np.int64) + r0
            ci = np.asarray(sl.col_ids, np.int64)
            first = ci[np.minimum(ip[:-1], max(ci.size - 1, 0))] - rid
            last = ci[np.maximum(ip[1:] - 1, 0)] - rid
            lo[0] = min(lo[0], int(first[ne].min()))
            hi[0] = max(hi[0], int(last[ne].max()))
        if process_count() > 1:
            lo = -np.max(_host_all_gather(-lo), axis=0)
            hi = np.max(_host_all_gather(hi), axis=0)
        return int(lo[0]), int(hi[0])

    a_dmin, a_dmax = extremes(ash)
    b_dmin, b_dmax = extremes(bsh)
    if a_dmin > a_dmax or b_dmin > b_dmax:
        return None
    span_a = a_dmax - a_dmin + 1
    span_b = b_dmax - b_dmin + 1
    if span_a > cfg.sdia_span_cap or span_b > cfg.sdia_span_cap:
        return None
    # halo must come from the immediate ring neighbors only
    if max(0, -a_dmin) > m_loc or max(0, a_dmax) > m_loc:
        return None

    def offsets(sh, dmin, span):
        bits = np.zeros(span, np.int64)
        for d, sl in sh.local.items():
            ip = np.asarray(sl.row_offsets, np.int64)
            r0 = sh.ranges[d][0]
            rid = np.repeat(np.arange(sl.rows, dtype=np.int64) + r0,
                            ip[1:] - ip[:-1])
            dd = np.asarray(sl.col_ids, np.int64) - rid - dmin
            bits |= np.bincount(dd, minlength=span).astype(bool).astype(
                np.int64)
        bits = _combine_max(bits)
        return np.flatnonzero(bits) + dmin

    off_a = offsets(ash, a_dmin, span_a)
    off_b = (off_a if bsh is ash
             else offsets(bsh, b_dmin, span_b))
    nd_a, nd_b = len(off_a), len(off_b)
    if nd_a * nd_b > cfg.sdia_pair_cap:
        return None
    if m * nd_a * nd_b > cfg.dia_waste_cap * max(total_ops, 1.0):
        return None
    off_c = np.unique(off_a[:, None] + off_b[None, :])
    nd_c = len(off_c)
    # per-shard plane working set (value + hit planes, window, output,
    # staged) within the memory budget and int32 flat-slot range
    win = m_loc + span_a
    if max(nd_a, nd_b, nd_c) * max(m_loc, win) >= 2 ** 31:
        return None
    per_shard = 4 * (2 * nd_a * m_loc + 2 * nd_b * win
                     + 2 * nd_c * m_loc + 3 * nd_c * m_loc)
    if per_shard > cfg.dia_mem_budget:
        return None
    return dict(off_a=tuple(int(x) for x in off_a),
                off_b=tuple(int(x) for x in off_b),
                off_c=tuple(int(x) for x in off_c),
                dmin_a=a_dmin, dmin_b=b_dmin,
                span_a=span_a, span_b=span_b)


def _mesh_dense_gate(ash: RowShards, bsh: RowShards, b_len_h: np.ndarray,
                     cfg: SpgemmConfig, D: int):
    """Host eligibility for the mesh dense route, from per-shard local
    metadata only. The single-device dense-tile criteria hoisted to
    per-shard row tiles: EVERY non-empty tile of ``dense_tile_rows``
    consecutive local rows must have A-column span <= dense_kw,
    output-column span <= dense_cw, and per-row lengths <= dense_la /
    dense_lb (full cover only). Returns dict(kb, cb (D, K) tile window
    bases, K, kw, cw, la, lb) or None. The route replicates B, so it is
    consulted only under exchange == "allgather"."""
    if not cfg.enable_dense:
        return None
    tr = cfg.dense_tile_rows
    m_loc = max([1] + [r1 - r0 for r0, r1 in ash.ranges])
    K = -(-m_loc // tr)
    k_dim = bsh.m
    k_loc = max(1, -(-k_dim // D))
    INTM = np.iinfo(np.int64).max

    # global per-B-row first / last+1 column (owner-combined; empty rows:
    # first = INTM, last+1 = 0 — both max-combine safely)
    bf = np.zeros((D, k_loc), np.int64)
    bl1 = np.zeros((D, k_loc), np.int64)
    for d, sl in bsh.local.items():
        ip = np.asarray(sl.row_offsets, np.int64)
        ci = np.asarray(sl.col_ids, np.int64)
        ln = ip[1:] - ip[:-1]
        ne = ln > 0
        if ci.size:
            f = np.where(ne, ci[np.minimum(ip[:-1], ci.size - 1)], INTM)
            l1 = np.where(ne, ci[np.maximum(ip[1:] - 1, 0)] + 1, 0)
        else:
            f = np.full(sl.rows, INTM, np.int64)
            l1 = np.zeros(sl.rows, np.int64)
        bf[d, : sl.rows] = f
        bl1[d, : sl.rows] = l1
    bf = _combine_max(bf).reshape(-1)[:k_dim]
    bl1 = _combine_max(bl1).reshape(-1)[:k_dim]

    kb = np.zeros((D, K), np.int64)
    cb = np.zeros((D, K), np.int64)
    # [violations, kspan, cspan, la, lb] per shard, owner-combined
    stat = np.zeros((D, 5), np.int64)
    for d, sl in ash.local.items():
        ip = np.asarray(sl.row_offsets, np.int64)
        ci = np.asarray(sl.col_ids, np.int64)
        lens = ip[1:] - ip[:-1]
        ne = lens > 0
        if ci.size:
            afirst = np.where(ne, ci[np.minimum(ip[:-1], ci.size - 1)],
                              INTM)
            alast = np.where(ne, ci[np.maximum(ip[1:] - 1, 0)], -1)
            starts = np.minimum(ip[:-1], ci.size - 1)
            rmin = np.minimum.reduceat(bf[ci], starts)
            rmax = np.maximum.reduceat(bl1[ci] - 1, starts)
            rlb = np.maximum.reduceat(b_len_h[ci], starts)
            cmin = np.where(ne, rmin, INTM)
            cmax = np.where(ne, rmax, -1)
            lb_r = np.where(ne, rlb, 0)
        else:
            afirst = np.full(sl.rows, INTM, np.int64)
            alast = np.full(sl.rows, -1, np.int64)
            cmin = np.full(sl.rows, INTM, np.int64)
            cmax = np.full(sl.rows, -1, np.int64)
            lb_r = np.zeros(sl.rows, np.int64)

        def tiles(x, red, fill):
            pad = K * tr - sl.rows
            xp = (np.concatenate([x, np.full(pad, fill, np.int64)])
                  if pad else x)
            return red(xp.reshape(K, tr), axis=1)

        t_kmin = tiles(afirst, np.min, INTM)
        t_kmax = tiles(alast, np.max, -1)
        t_cmin = tiles(cmin, np.min, INTM)
        t_cmax = tiles(cmax, np.max, -1)
        t_la = tiles(lens, np.max, 0)
        t_lb = tiles(lb_r, np.max, 0)
        live = t_kmax >= 0
        kspan = np.where(live, t_kmax - t_kmin + 1, 0)
        # output-empty tiles (all products vanish) keep cspan 0
        cspan = np.where(live & (t_cmax >= 0), t_cmax - t_cmin + 1, 0)
        bad = live & ((kspan > cfg.dense_kw) | (cspan > cfg.dense_cw)
                      | (t_la > cfg.dense_la) | (t_lb > cfg.dense_lb))
        stat[d] = [int(bad.sum()), int(kspan.max(initial=0)),
                   int(cspan.max(initial=0)), int(t_la.max(initial=0)),
                   int(t_lb.max(initial=0))]
        kb[d] = np.where(live, t_kmin, 0)
        cb[d] = np.where(live & (t_cmax >= 0), t_cmin, 0)
    stat = _combine_max(stat)
    kb = _combine_max(kb)
    cb = _combine_max(cb)
    if int(stat[:, 0].max(initial=0)) > 0:
        return None

    def up(x, q, lo):
        return max(lo, -(-int(x) // q) * q)

    kw = up(stat[:, 1].max(initial=1), 128, 128)
    cw = up(stat[:, 2].max(initial=1), 128, 128)
    la = up(stat[:, 3].max(initial=1), 8, 8)
    lb = up(stat[:, 4].max(initial=1), 8, 8)
    # per-shard working set within the memory budget
    out_cap = _pow2ceil(max(1, m_loc * cw))
    bytes_ = 4 * (2 * K * tr * kw + 2 * K * kw * cw + 4 * K * tr * cw
                  + K * tr * (la + lb)) + out_cap * 12
    if bytes_ > cfg.dia_mem_budget:
        return None
    return dict(kb=kb.astype(np.int32), cb=cb.astype(np.int32), K=K,
                kw=kw, cw=cw, la=la, lb=lb)


def _pack_payload(bx, bd, f64: bool):
    """B's records: (col, value bits) for float32, (col, lo, hi) words for
    float64 (12 bytes, the reference's CH = 3)."""
    if f64:
        return torch.cat([bx[:, None].to(I32),
                          bd.contiguous().view(I32).reshape(-1, 2)], dim=1)
    return pack_csr_arrays(bx, bd)


# ---------------------------------------------------------------------------
# The mesh diagonal-plane route: banded and stencil inputs (square, equal
# row blocks) as per-shard diagonal planes, the B planes widened by a ring
# halo of the neighbours' edge rows, then the list-offset convolution of
# ops/dia.py. Plain torch, as the reference's route is plain jnp.
# ---------------------------------------------------------------------------


def _shard_planes(ip, cx, cd, r0, lut, *, dmin: int, nd: int, m_loc: int):
    """One shard's value and float32 hit planes (nd, m_loc): the nonzero
    at local row i, global column c sits in plane lut[c - (r0 + i) -
    dmin]. The padding nonzeros go to ``dia_planes``' drop slot; the
    planes are zero everywhere else."""
    t = torch.arange(cx.shape[0], dtype=I32, device=cx.device)
    live = t < ip[-1]
    rid = _count_le(ip[1:], t)
    dd = torch.clamp(cx - (rid + r0) - dmin, 0, lut.shape[0] - 1)
    slot = torch.where(live, lut[dd] * m_loc + rid, nd * m_loc)
    return dia_planes(slot, cd, span=nd, rows=m_loc)


class _SdiaStep:
    """The diagonal-plane step: planes, the ring halo (two ppermute rounds
    a plane kind: the left halo from shard d-1, the right from d+1), the
    convolution, the rank compaction and the emission."""

    def __init__(self, sd: dict, m_loc: int, n_cols: int, out_cap: int,
                 same: bool):
        self.m_loc, self.n_cols, self.out_cap = m_loc, n_cols, out_cap
        self.same = same
        self.off_a, self.off_b = sd["off_a"], sd["off_b"]
        self.off_c = sd["off_c"]
        self.dmin_a, self.dmin_b = sd["dmin_a"], sd["dmin_b"]
        self.lut_a = sdia_lut(self.off_a, sd["dmin_a"], sd["span_a"])
        self.lut_b = sdia_lut(self.off_b, sd["dmin_b"], sd["span_b"])
        self.halo_l = max(0, -min(self.off_a))
        self.halo_r = max(0, max(self.off_a))
        oc_index = {dd: i for i, dd in enumerate(self.off_c)}
        # output plane -> [(ia, da, ib)], in the reference's order
        self.groups: dict = {}
        for ia, da in enumerate(self.off_a):
            for ib, db in enumerate(self.off_b):
                self.groups.setdefault(oc_index[da + db], []).append(
                    (ia, da, ib))

    def _window(self, mesh, pl):
        """(nd_b, halo_l + m_loc + halo_r) per shard: the left halo from
        the ring's previous shard, the right from its next. At the mesh's
        two ends the halo wraps round and holds rows that only ever meet
        A-plane entries of zero (no A nonzero lies outside the matrix)."""
        m_loc, hl, hr = self.m_loc, self.halo_l, self.halo_r
        left = (ppermute(mesh, {d: pl[d][:, m_loc - hl:] for d in pl}, 1)
                if hl else None)
        right = (ppermute(mesh, {d: pl[d][:, :hr] for d in pl}, -1)
                 if hr else None)
        out = {}
        for d in pl:
            parts = [pl[d]]
            if left is not None:
                parts.insert(0, left[d])
            if right is not None:
                parts.append(right[d])
            out[d] = torch.cat(parts, dim=1) if len(parts) > 1 else pl[d]
        return out

    def __call__(self, mesh, ai, ax, ad, bi, bx, bd, r0):
        m_loc = self.m_loc
        nd_a, nd_b, nd_c = len(self.off_a), len(self.off_b), len(self.off_c)
        av, ah, bv, bh = {}, {}, {}, {}
        for d in mesh.local:
            dev = mesh.devices[d]
            lut_a = upload(self.lut_a, dev)
            av[d], ah[d] = _shard_planes(ai[d], ax[d], ad[d], r0[d][0],
                                         lut_a, dmin=self.dmin_a, nd=nd_a,
                                         m_loc=m_loc)
            if self.same:
                bv[d], bh[d] = av[d], ah[d]
            else:
                bv[d], bh[d] = _shard_planes(
                    bi[d], bx[d], bd[d], r0[d][0], upload(self.lut_b, dev),
                    dmin=self.dmin_b, nd=nd_b, m_loc=m_loc)
        bw_v, bw_h = self._window(mesh, bv), self._window(mesh, bh)
        del bv, bh
        nnz_row, cols, vals = {}, {}, {}
        for d in mesh.local:
            dev = mesh.devices[d]
            # each output plane sums its pairs from zero in the
            # reference's group order, one multiply-add over the shard's
            # rows a pair (the reference's row blocks only bound XLA's
            # temporaries; they change no element's order of adds)
            c_val = torch.zeros((nd_c, m_loc), dtype=av[d].dtype, device=dev)
            c_cnt = torch.zeros((nd_c, m_loc), dtype=torch.float32,
                                device=dev)
            # the planes' rows as views made once (a view a pair costs the
            # host more than the pair's add costs the card)
            cv, cc = c_val.unbind(0), c_cnt.unbind(0)
            a_v, a_h = av[d].unbind(0), ah[d].unbind(0)
            b_v, b_h = bw_v[d].unbind(0), bw_h[d].unbind(0)
            for oc in range(nd_c):
                for ia, da, ib in self.groups.get(oc, ()):
                    s0 = self.halo_l + da
                    cv[oc].addcmul_(a_v[ia], b_v[ib][s0: s0 + m_loc])
                    cc[oc].addcmul_(a_h[ia], b_h[ib][s0: s0 + m_loc])
            del cv, cc, a_v, a_h, b_v, b_h
            # rows first for the compaction (its rank scan runs along the
            # rows, row-major); exact: fp32 counts of 1.0 adds
            present = (c_cnt > 0.5).t().contiguous()
            del c_cnt
            counts = torch.sum(present, dim=1, dtype=I32)
            # the column is the global row plus the plane's diagonal; the
            # compaction adds the local row, so the offsets shift by r0
            doffs = upload(np.asarray(self.off_c, np.int32), dev) + r0[d][0]
            cols_s, vals_s = _rank_compact(
                c_val.t().contiguous(), present, sc=nd_c, m=m_loc,
                n_cols=self.n_cols, base_c=0, doffs=doffs)
            del c_val, present
            nnz_row[d], cols[d], vals[d] = _emit_rows(
                counts, cols_s, vals_s, self.out_cap)
        return _assembled(mesh, (nnz_row, cols, vals))


def _emit_rows(counts, cols_s, vals_s, out_cap: int):
    """Each row's first counts[i] staged entries at its CSR offset in the
    padded (out_cap,) output. Returns (counts, cols, vals)."""
    dev = counts.device
    offs = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                      cumsum1d(counts)])
    j = torch.arange(cols_s.shape[1], dtype=I32, device=dev)[None, :]
    flat = torch.where(j < counts[:, None], offs[:-1][:, None] + j, out_cap)
    c_cols = torch.zeros(out_cap + 1, dtype=I32, device=dev)
    c_cols[flat] = cols_s.to(I32)
    c_vals = torch.zeros(out_cap + 1, dtype=vals_s.dtype, device=dev)
    c_vals[flat] = vals_s
    return counts, c_cols[:out_cap], c_vals[:out_cap]


def _mesh_sdia_spgemm(ash: RowShards, bsh: RowShards, mesh: RowMesh,
                      cfg: SpgemmConfig, sd: dict, tdt, b_nnz: int):
    """The mesh diagonal-plane route (see the section comment). Output as
    the stream mesh's ((nnz_row, cols, vals, meta),
    ``mesh_stream_to_host_csr``)."""
    D = mesh.size
    m, n = ash.m, bsh.n
    m_loc = max(1, -(-m // D))
    same = bsh is ash
    ai_h, ax_h, ad_h, a_ranges = _stack_shards(ash, _np_dtype(tdt))
    bi_h, bx_h, bd_h, _ = ((ai_h, ax_h, ad_h, a_ranges) if same
                           else _stack_shards(bsh, _np_dtype(tdt)))
    r0s = np.array([r0 for r0, _ in a_ranges], np.int32).reshape(D, 1)
    nd_b, nd_c = len(sd["off_b"]), len(sd["off_c"])
    out_cap = _pow2ceil(max(m_loc * nd_c, 1))
    a_live, b_live = ai_h[:, -1], bi_h[:, -1]
    args_ = (put(mesh, ai_h), put(mesh, ax_h, a_live),
             put_values(mesh, ad_h, a_live, tdt), put(mesh, bi_h),
             put(mesh, bx_h, b_live), put_values(mesh, bd_h, b_live, tdt),
             put(mesh, r0s))
    # the reference's key also holds its row block, a function of m_loc
    key = ("sdia", mesh.key(), cfg, str(tdt), m, n, m_loc, sd["off_a"],
           sd["off_b"], sd["off_c"], sd["dmin_a"], sd["dmin_b"], out_cap,
           same, _argsig(args_, D))
    step, reused = _cached_step(key, lambda: _SdiaStep(sd, m_loc, n,
                                                       out_cap, same))
    _set_last_exec(step, (mesh,) + args_)
    nnz_row, cols, vals = step(mesh, *args_)
    itemsize = tdt.itemsize
    halo = max(0, -min(sd["off_a"])) + max(0, max(sd["off_a"]))
    stats = NeedsetStats(
        allgather_bytes=b_nnz * (4 + itemsize),
        needset_bytes=halo * nd_b * 2 * itemsize,
        pairs_nnz=np.zeros((D, D), np.int64),
        mode="dia_halo",
    )
    meta = {"ranges": a_ranges, "out_cap": out_cap, "m_loc": m_loc,
            "shape": (m, n), "stats": stats, "ksplit": None,
            "route": "sdia", "compiled_reused": reused}
    return nnz_row, cols, vals, meta


# ---------------------------------------------------------------------------
# The mesh dense-window route: B gathered whole, each shard's row tiles as
# densified window products (ops/dense.dense_tiles, with the local A and
# the gathered B addressed shard by shard), then a rank-sort compaction
# (kernel K2).
# ---------------------------------------------------------------------------


class _DenseStep:
    """The dense-window step: B's indptr, columns and values gathered from
    every shard, then each shard's K tiles of ``tile_rows`` rows at once:
    A's (K*tr, la) and B's (K*kw, lb) rectangles from the gate's window
    bases, densified (``cfg.dense_densify``: two K2 sorts a side, or one
    scatter), the values by a full-precision ``bmm``, the pattern counts
    by a bfloat16 ``bmm`` accumulated in float32 (exact: counts <= la),
    and each row's present entries moved to its front in column order by
    one K2 sort."""

    def __init__(self, cfg: SpgemmConfig, dn: dict, D: int, m_loc: int,
                 k_dim: int, n_cols: int, bnnz_max: int, out_cap: int):
        self.tr, self.D, self.m_loc = cfg.dense_tile_rows, D, m_loc
        self.K, self.kw, self.cw = dn["K"], dn["kw"], dn["cw"]
        self.la, self.lb = dn["la"], dn["lb"]
        self.k_dim, self.n_cols = k_dim, n_cols
        self.bnnz_max, self.out_cap = bnnz_max, out_cap
        self.dens = (_densify_scatter if cfg.dense_densify == "scatter"
                     else _densify_sorted)

    def __call__(self, mesh, ai, ax, ad, bi, bx, bd, kb, cb, rdv):
        g_indptr = all_gather(mesh, bi)                    # (D, k_loc+1)
        g_cols = all_gather(mesh, bx)
        g_vals = all_gather(mesh, bd)
        out = {}
        for d in mesh.local:
            out[d] = self._shard(ai[d], ax[d], ad[d], g_indptr[d],
                                 g_cols[d].reshape(-1),
                                 g_vals[d].reshape(-1), kb[d], cb[d],
                                 rdv[d][0])
        return _assembled(mesh, ({d: o[0] for d, o in out.items()},
                                 {d: o[1] for d, o in out.items()},
                                 {d: o[2] for d, o in out.items()}))

    def _shard(self, ai, ax, ad, gi, g_cols, g_vals, kb, cb, nrows):
        K, tr, kw, cw = self.K, self.tr, self.kw, self.cw
        dev = ai.device
        # global B row q lives in shard q // k_loc at its local offset: the
        # gathered indptrs give (start, len) with the shards' pad gaps
        base = torch.arange(self.D, dtype=I32, device=dev)[:, None] \
            * self.bnnz_max
        b_start = (gi[:, :-1] + base).reshape(-1)
        b_len = (gi[:, 1:] - gi[:, :-1]).reshape(-1)

        # A side: (K*tr, la) rectangles into (K*tr, kw) windows
        rows = torch.arange(K * tr, dtype=I32, device=dev)
        vrow = rows < nrows
        acol, aval, alive = _gather_rect(ai, ax, ad, rows, vrow, self.la)
        kb_row = kb.repeat_interleave(tr)
        kloc = torch.where(alive, acol - kb_row[:, None], kw).to(I32)
        A_dense, A_hit = self.dens(kloc, aval, kw)

        # B side: (K*kw, lb) rectangles over the tiles' k-windows; window
        # rows the shard's A never references meet zero A_dense columns
        ks = (kb[:, None] + torch.arange(kw, dtype=I32, device=dev)[None, :]
              ).reshape(-1)
        vk = ks < self.k_dim
        kq = torch.where(vk, ks, 0)
        q0 = b_start[kq]
        qln = torch.where(vk, b_len[kq], 0)
        jb = torch.arange(self.lb, dtype=I32, device=dev)[None, :]
        blive = jb < qln[:, None]
        bidx = torch.where(blive, q0[:, None] + jb, 0)
        bcol = torch.where(blive, g_cols[bidx], 0)
        bval = torch.where(blive, g_vals[bidx], 0.0)
        cb_k = cb.repeat_interleave(kw)
        cloc = torch.where(blive, bcol - cb_k[:, None], cw).to(I32)
        B_dense, B_hit = self.dens(cloc, bval, cw)

        C_vals = _full_precision_bmm(
            A_dense.reshape(K, tr, kw), B_dense.reshape(K, kw, cw)
        ).reshape(K * tr, cw)
        C_cnt = torch.bmm(
            A_hit.reshape(K, tr, kw).to(torch.bfloat16),
            B_hit.reshape(K, kw, cw).to(torch.bfloat16)).reshape(K * tr, cw)
        del A_dense, A_hit, B_dense, B_hit

        cb_row = cb.repeat_interleave(tr)
        tcw = torch.arange(cw, dtype=I32, device=dev)[None, :]
        present = ((C_cnt > 0.5) & vrow[:, None]
                   & ((cb_row[:, None] + tcw) < self.n_cols))
        # rank-sort compaction: present entries to the row front, in
        # column order (the keys are distinct within a row)
        rank = torch.cumsum(present, 1, dtype=I32) - 1
        key = torch.where(present, rank, cw + tcw).to(I32)
        cols_g = torch.where(present, cb_row[:, None] + tcw,
                             self.n_cols).to(I32)
        _, (cols_c, moved) = _sort_rows(key, [cols_g, slot_payload(C_vals)])
        vals_c = by_slot(C_vals, moved)
        m_loc = self.m_loc
        counts = torch.sum(present[:m_loc], dim=1, dtype=I32)
        return _emit_rows(counts, cols_c[:m_loc], vals_c[:m_loc],
                          self.out_cap)


def _mesh_dense_spgemm(ash: RowShards, bsh: RowShards, mesh: RowMesh,
                       cfg: SpgemmConfig, dn: dict, tdt, b_nnz: int):
    """The mesh dense-window route (see the section comment). Output as
    the stream mesh's."""
    D = mesh.size
    m, n = ash.m, bsh.n
    k_dim = bsh.m
    tr, K = cfg.dense_tile_rows, dn["K"]
    ai_h, ax_h, ad_h, a_ranges = _stack_shards(ash, _np_dtype(tdt))
    bi_h, bx_h, bd_h, _ = _stack_shards(bsh, _np_dtype(tdt))
    bnnz_max = bx_h.shape[1]
    m_loc = ai_h.shape[1] - 1
    rows_d = np.array([[r1 - r0] for r0, r1 in a_ranges], np.int32)
    out_cap = _pow2ceil(max(1, m_loc * dn["cw"]))
    a_live, b_live = ai_h[:, -1], bi_h[:, -1]
    args_ = (put(mesh, ai_h), put(mesh, ax_h, a_live),
             put_values(mesh, ad_h, a_live, tdt), put(mesh, bi_h),
             put(mesh, bx_h, b_live), put_values(mesh, bd_h, b_live, tdt),
             put(mesh, dn["kb"]), put(mesh, dn["cb"]), put(mesh, rows_d))
    key = ("dense", mesh.key(), cfg, str(tdt), m, n, k_dim, tr, K,
           dn["kw"], dn["cw"], dn["la"], dn["lb"], m_loc, out_cap, bnnz_max,
           _argsig(args_, D))
    step, reused = _cached_step(key, lambda: _DenseStep(
        cfg, dn, D, m_loc, k_dim, n, bnnz_max, out_cap))
    _set_last_exec(step, (mesh,) + args_)
    nnz_row, cols, vals = step(mesh, *args_)
    rep = b_nnz * (4 + tdt.itemsize)
    stats = NeedsetStats(allgather_bytes=rep, needset_bytes=rep,
                         pairs_nnz=np.zeros((D, D), np.int64),
                         mode="dense_allgather")
    meta = {"ranges": a_ranges, "out_cap": out_cap, "m_loc": m_loc,
            "shape": (m, n), "stats": stats, "ksplit": None,
            "route": "dense", "compiled_reused": reused}
    return nnz_row, cols, vals, meta


def mesh_stream_spgemm(
    a,
    b,
    mesh: RowMesh,
    cfg: Optional[SpgemmConfig] = None,
    exchange: str = "allgather",
    dtype=torch.float32,
):
    """C = A @ B over the row mesh (see the module docstring). Returns
    (nnz_row, cols, vals, meta): padded row-major per-shard outputs as
    global (D*m_loc,), (D*out_cap,), (D*out_cap,) tensors; assemble with
    ``mesh_stream_to_host_csr``.

    ``a`` / ``b``: HostCSR (the full matrix on this process), or RowShards
    (pre-sharded: this process holds only its own shards' rows; host
    metadata is combined across processes as small padded arrays and the
    need-set plan is computed on the devices).

    ``dtype``: float32 (packed 8-byte B records) or float64 (12-byte
    records). ``exchange``: "allgather", "needset" or "needset_overlap".
    ``meta["route"]`` names the route the gates took: "sdia" (banded and
    stencil inputs), "dense" (tile-bounded inputs under allgather) or
    "stream"."""
    D = mesh.size
    cfg = cfg or SpgemmConfig()
    check_knobs(cfg)
    tdt = torch_dtype(dtype)
    if tdt not in VALUE_DTYPES:
        raise TypeError(f"values must be float16, bfloat16, float32 or "
                        f"float64, not {tdt}")
    f64 = tdt == torch.float64
    np_dtype = np.float64 if f64 else np.float32
    CH = 3 if f64 else 2           # payload channels: col + value words
    rec_bytes = 4 * CH
    bsh = b if isinstance(b, RowShards) else RowShards.from_global(b, D)
    if bsh.ranges_ is not None:
        eq = RowShards(m=bsh.m, n=bsh.n, D=bsh.D, local={}).ranges
        if list(map(tuple, bsh.ranges)) != eq:
            raise ValueError(
                "B must be sharded in equal ceil(m/D) row blocks (the "
                "owner arithmetic col // k_loc depends on it); only A "
                "supports ops-balanced ranges")
    b_len_h = _shard_row_lens(bsh)
    b_nnz = int(b_len_h.sum())
    if isinstance(a, RowShards):
        ash = a
    elif cfg.mesh_balance_rows:
        # ops-balanced contiguous A partition, only when equal-count ranges
        # are imbalanced (> 1.25x max/mean): aligned structure
        # (block-diagonal inputs) keeps its zero-communication boundaries
        ops_full = _host_row_ops(a, b_len_h)
        w = np.maximum(ops_full, cfg.stream_min_q)
        eq = RowShards(m=a.rows, n=a.cols, D=D, local={}).ranges
        eq_tot = np.array([int(w[r0:r1].sum()) for r0, r1 in eq])
        mean_w = max(float(eq_tot.mean()), 1.0)
        if float(eq_tot.max(initial=0)) > 1.25 * mean_w:
            ash = RowShards.from_global(
                a, D, ranges=balanced_row_ranges(ops_full, D,
                                                 cfg.stream_min_q))
        else:
            ash = RowShards.from_global(a, D)
    else:
        ash = RowShards.from_global(a, D)
    if ash.D != D or bsh.D != D:
        raise ValueError(
            f"RowShards built for D={ash.D}/{bsh.D}, mesh has {D}")
    if ash.n != bsh.m:
        raise ValueError(
            f"dimension mismatch: A is {(ash.m, ash.n)}, "
            f"B is {(bsh.m, bsh.n)}")
    if exchange not in ("allgather", "needset", "needset_overlap"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    n_cols = bsh.n

    # per-shard row ops (owners compute, combined): the host analysis
    # all static shapes derive from — O(m) metadata, no payloads
    a_ranges0 = ash.ranges
    m_locA = max([1] + [r1 - r0 for r0, r1 in a_ranges0])
    ops_sh = np.zeros((D, m_locA), np.int64)
    for d, sl in ash.local.items():
        o = _host_row_ops(sl, b_len_h)
        ops_sh[d, : o.shape[0]] = o
    ops_sh = _combine_max(ops_sh)

    # the mesh diagonal-plane route: banded and stencil inputs take the
    # convolution with its fixed small halo, whatever the exchange (the
    # halo is the exchange)
    sd = _mesh_sdia_gate(ash, bsh, cfg, float(ops_sh.sum()), D)
    if sd is not None:
        return _mesh_sdia_spgemm(ash, bsh, mesh, cfg, sd, tdt, b_nnz)
    # the mesh dense route: tile-bounded inputs. It replicates B, so the
    # gate is consulted only when the caller chose replication
    if exchange == "allgather":
        dn = _mesh_dense_gate(ash, bsh, b_len_h, cfg, D)
        if dn is not None:
            return _mesh_dense_spgemm(ash, bsh, mesh, cfg, dn, tdt, b_nnz)
    if tdt.itemsize == 2:
        # the reference packs B's records as (col, value bits) words for
        # any type but float64 and its bitcast of a 16-bit value fails
        raise TypeError(f"the mesh stream route packs 32-bit values, not "
                        f"{tdt} (speck_tpu raises here too); the diagonal-"
                        "plane and dense routes take 16-bit values")

    # k-split rows (single-row sharding): removed from their owner's
    # local A, their slots re-dealt by B-row owner (_plan_ksplit_shards)
    k_locB = max(1, -(-bsh.m // D))
    ash_eff, ops_sh, ksp = _plan_ksplit_shards(
        ash, ops_sh, b_len_h, D, k_locB, cfg.mesh_split_min_ops,
        cfg.mesh_subrow_max_ops, np_dtype, owned=mesh.local)

    ai_h, ax_h, ad_h, a_ranges = _stack_shards(ash_eff, np_dtype)
    m_loc = ai_h.shape[1] - 1

    # per-shard stream shape parameters (one shape across shards); the
    # totals use the exact host twin of the device's tight layout
    min_q = cfg.stream_min_q
    shard_ops = []
    for d, (r0, r1) in enumerate(a_ranges):
        ops = ops_sh[d, : r1 - r0]
        assert not ops.size or int(ops.max(initial=0)) <= 2 ** 30, \
            "post-split row past 2^30 (unreachable: _plan_ksplit_shards)"
        shard_ops.append(ops)
    W = cfg.stream_width
    total_qs = []
    for (r0, r1), ops in zip(a_ranges, shard_ops):
        total_qs.append(tight_total_host(ops, W, min_q))
        if total_qs[-1] >= 2 ** 31:
            raise ValueError(
                f"shard rows {r0}:{r1} pack to {total_qs[-1]} stream "
                "slots, past the 2^31 int32 ceiling; use more shards")
    G = max(1, cfg.product_budget // W)
    # exact-size G: when every shard's stream fits one chunk, size the
    # chunk to the largest shard's live rect rows (a multiple of 8); the
    # k-split sub-pipeline shares CP, so its totals join the sizing
    need = -(-max(total_qs + [1]) // W)
    if ksp is not None:
        need = max(need, -(-max(
            [tight_total_host(ksp["sub_ops"][s], W, min_q)
             for s in range(D)] + [1]) // W))
    if need < G:
        G = max(8, -(-need // 8) * 8) if need > 8 else max(1, need)
    CP = G * W
    n_chunks = max(1, -(-max(total_qs + [1]) // CP))
    out_cap_base = max(total_qs + [1])
    r_wide_max, wide_rid_h, level_specs = _mesh_wide_plans(
        shard_ops, W, cfg.stream_level_factor, cfg.stream_max_width,
        n_cols=n_cols)

    # ---- k-split static parameters ----
    ks = None
    if ksp is not None:
        n_split, n_rows = ksp["n_split"], ksp["n_rows"]
        max_parts = ksp["max_parts"]
        sub_ops = ksp["sub_ops"]            # (D, n_rows) per part-row
        tq_s = [tight_total_host(sub_ops[s], W, min_q) for s in range(D)]
        if max(tq_s) >= 2 ** 31:
            raise ValueError(
                f"a k-split shard packs to {max(tq_s)} stream slots, "
                "past the 2^31 int32 ceiling; use more shards")
        rw_max_s, spl_wide_rid_h, spl_specs = _mesh_wide_plans(
            [sub_ops[s] for s in range(D)], W,
            cfg.stream_level_factor, cfg.stream_max_width,
            n_cols=n_cols)
        P_spl = _pow2ceil(max(1, min(n_cols, int(sub_ops.max(initial=1)))))
        PM = max_parts * P_spl
        Wm = _pow2ceil(D * PM)
        # owner shard / local row of each split row; non-owners drop
        spl_tgt_h = np.full((D, n_split), m_loc, np.int32)
        spl_emit_h = np.full((D, n_split), -1, np.int32)
        out_extra = np.zeros(D, np.int64)
        for j, r in enumerate(ksp["split_ids"]):
            for s, (r0, r1) in enumerate(a_ranges):
                if r0 <= r < r1:
                    spl_tgt_h[s, j] = r - r0
                    spl_emit_h[s, j] = r - r0
                    out_extra[s] += min(n_cols, D * PM)
        ks = dict(n_split=n_split, n_rows=n_rows, P=P_spl, PM=PM,
                  Wm=Wm, n_chunks=max(1, -(-max(tq_s + [1]) // CP)),
                  rw_max=rw_max_s, specs=spl_specs)
        out_cap_base += int(out_extra.max(initial=0))
    out_cap = _pow2ceil(out_cap_base)
    body = _ShardBody(cfg, m_loc, W, G, n_chunks, out_cap, n_cols,
                      r_wide_max=r_wide_max, level_specs=level_specs, ks=ks,
                      f64=f64)
    # static signature of the shard body for the step cache (everything
    # that shapes its work beyond the argument shapes)
    ks_key = None if ks is None else (
        ks["n_split"], ks["n_rows"], ks["P"], ks["PM"], ks["Wm"],
        ks["n_chunks"], ks["rw_max"], _specs_key(ks["specs"]))
    body_key = (m_loc, W, G, n_chunks, out_cap, n_cols, r_wide_max,
                _specs_key(level_specs), ks_key, f64)
    compiled_reused = False

    def put_(x, live=None):
        return put(mesh, x, live)

    # A's nonzeros are padded to the widest shard: only the live ones cross
    a_live = ai_h[:, -1]

    def ladder_args(wide_rid, specs):
        """A pipeline's wide_rid and level maps."""
        args = [put_(wide_rid)]
        for spec in specs:
            args.append(put_(spec["in_map"]))
            args.append(put_(spec["final"]))
        return args

    def ksplit_args(spl_cols_arr):
        """The split pipeline's inputs (none without a k-split);
        spl_cols_arr is mode-specific: global B row ids under allgather,
        received-buffer slots under needset."""
        if ksp is None:
            return []
        return [put_(ksp["spl_indptr"].astype(np.int32)),
                (spl_cols_arr if isinstance(spl_cols_arr, dict)
                 else put_(np.asarray(spl_cols_arr, np.int32))),
                put_(ksp["spl_vals"]), put_(spl_tgt_h), put_(spl_emit_h),
                *ladder_args(spl_wide_rid_h, ks["specs"])]

    def extra_args(spl_cols_arr):
        """wide_rid + main level maps (+ the split pipeline's inputs)."""
        return (ladder_args(wide_rid_h, level_specs)
                + ksplit_args(spl_cols_arr))

    n_ladder = (1 + 2 * len(level_specs)
                + ((6 + 2 * len(ks["specs"])) if ksp is not None else 0))

    def run_allgather():
        nonlocal compiled_reused
        bi_h, bx_h, bd_h, _ = _stack_shards(bsh, np_dtype)
        bnnz_max = bx_h.shape[1]
        b_live = bi_h[:, -1]
        args_ = (put_(ai_h), put_(ax_h, a_live), put_(ad_h, a_live),
                 put_(bi_h), put_(bx_h, b_live), put_(bd_h, b_live),
                 *extra_args(ksp["spl_cols"] if ksp is not None else None))
        key = ("stream_ag", mesh.key(), cfg, str(tdt), body_key, bnnz_max,
               n_ladder, _argsig(args_, D))
        step, reused = _cached_step(key, lambda: _AllgatherStep(
            body, D, bnnz_max, CH, f64))
        compiled_reused = reused
        _set_last_exec(step, (mesh,) + args_)
        return step(mesh, *args_)

    stats = None
    if exchange == "allgather":
        nnz_row, cols, vals = run_allgather()
    else:
        k_loc = max(1, -(-bsh.m // D))
        if cfg.mesh_device_planning:
            # ---- need-set exchange plan on the devices; host work is
            # O(D^2) scalars only
            nnz_d_h = np.asarray(ai_h[:, -1], np.int32)
            ax_d = put_(ax_h, a_live)
            spl_d = (put_(ksp["spl_cols"].astype(np.int32))
                     if ksp is not None else None)
            dp = _plan_needset_device(
                mesh, ax_d, nnz_d_h, spl_d,
                ksp["spl_indptr"][:, -1] if ksp is not None else None,
                b_len_h, D, k_loc, pad_exact=cfg.mesh_round_pad_exact)
            pair_nnz = dp["pair_nnz"]
            round_nnz = dp["round_nnz"]
            rb_start_a, rb_len_a = dp["rb_start"], dp["rb_len"]
            ax_remap_a = _lut_gather(dp["lut"], ax_d)
            spl_cols_remap = (_lut_gather(dp["lut"], spl_d)
                              if ksp is not None else None)
            send_plans = dp["send_plans"]
        else:
            (pair_nnz, round_nnz, rb_start_a, rb_len_a, ax_remap_a,
             spl_cols_remap, send_plans) = _plan_needset_host(
                mesh, ash_eff, bsh, ax_h, ksp, b_len_h, a_ranges, D, k_loc,
                cfg.mesh_round_pad_exact)

        # ---- auto-fallback gate: each round pads to its largest
        # (dst, src) pair, which can still make a scattered need pattern
        # move MORE bytes than full replication; fall back to all_gather
        # and say so ----
        needset_bytes = int(sum(round_nnz[1:])) * rec_bytes
        allgather_bytes = b_nnz * rec_bytes
        if cfg.mesh_exchange_auto and needset_bytes > allgather_bytes:
            nnz_row, cols, vals = run_allgather()
            stats = NeedsetStats(
                allgather_bytes=allgather_bytes,
                needset_bytes=needset_bytes, pairs_nnz=pair_nnz,
                mode="allgather(auto)")
        else:
            live_sends = []
            for si, sv in send_plans():
                live_sends.append(si)
                live_sends.append(sv)
            bi_h, bx_h, bd_h, _ = _stack_shards(bsh, np_dtype)
            b_live = bi_h[:, -1]
            payload_rounds = [r for r in range(D) if round_nnz[r] > 0]
            head = (put_(ai_h), ax_remap_a, put_(ad_h, a_live),
                    put_(bx_h, b_live), put_(bd_h, b_live), rb_start_a,
                    rb_len_a)
            if exchange == "needset_overlap":
                groups, g_args = _overlap_groups(
                    ash_eff, ops_sh, a_ranges, m_loc, k_loc, D, W, CP,
                    cfg, n_cols)
                g_args = [put_(x) for x in g_args]
                extras = g_args + ksplit_args(spl_cols_remap)
                seg_off = [int(x) for x in np.concatenate(
                    [[0], np.cumsum(round_nnz)])]
                args_ = (*head, *extras, *live_sends)
                key = ("stream_ov", mesh.key(), cfg, str(tdt), m_loc, W, G,
                       out_cap, n_cols, tuple(int(x) for x in round_nnz),
                       tuple(payload_rounds),
                       tuple(g["round"] for g in groups), seg_off[-1],
                       tuple((g["round"], g["n_chunks"], g["rw_max"],
                              _specs_key(g["specs"])) for g in groups),
                       ks_key, len(extras), f64, _argsig(args_, D))
                step, compiled_reused = _cached_step(
                    key, lambda: _OverlapStep(
                        _ShardBody(cfg, m_loc, W, G, n_chunks, out_cap,
                                   n_cols, ks=ks, f64=f64, groups=groups),
                        payload_rounds, seg_off, len(extras), CH, f64))
            else:
                args_ = (*head, *extra_args(spl_cols_remap), *live_sends)
                key = ("stream_ns", mesh.key(), cfg, str(tdt), body_key,
                       tuple(int(x) for x in round_nnz),
                       tuple(payload_rounds), n_ladder, _argsig(args_, D))
                step, compiled_reused = _cached_step(
                    key, lambda: _NeedsetStep(body, payload_rounds,
                                              n_ladder, CH, f64))
            _set_last_exec(step, (mesh,) + args_)
            nnz_row, cols, vals = step(mesh, *args_)
            stats = NeedsetStats(
                # per-shard volume moved over the interconnect: all_gather
                # replicates all of B's records; the need-set rounds move
                # only the padded non-self rounds
                allgather_bytes=allgather_bytes,
                needset_bytes=needset_bytes,
                pairs_nnz=pair_nnz,
                mode=exchange,
            )

    meta = {"ranges": a_ranges, "out_cap": out_cap, "m_loc": m_loc,
            "shape": (ash.m, bsh.n), "stats": stats,
            "ksplit": _ksplit_meta(ksp), "route": "stream",
            "compiled_reused": compiled_reused}
    return nnz_row, cols, vals, meta


def _plan_needset_host(mesh, ash_eff, bsh, ax_h, ksp, b_len_h, a_ranges,
                       D: int, k_loc: int, pad_exact: bool):
    """The need-set plan on host numpy (``mesh_device_planning=False``;
    it needs every shard's payload on this process): the same products
    as ``_plan_needset_device``."""
    if not (ash_eff.all_local and bsh.all_local):
        raise ValueError(
            "host need-set planning needs the full matrices on "
            "every process; pre-sharded RowShards inputs require "
            "MeshDevicePlanning=true (the default)")
    b_off = np.concatenate([[0], np.cumsum(b_len_h)]).astype(np.int64)
    # need set per dst shard: unique B rows referenced by its A cols (plus
    # its k-split slots' cols — always self-owned, so they only enlarge
    # the zero-communication round 0)
    needs: List[np.ndarray] = []
    for s, (r0, r1) in enumerate(a_ranges):
        sl = ash_eff.local[s]
        cols_need = np.asarray(sl.col_ids, np.int64)
        if ksp is not None:
            nz_s = int(ksp["spl_indptr"][s, -1])
            cols_need = np.concatenate(
                [cols_need, ksp["spl_cols"][s, :nz_s].astype(np.int64)])
        needs.append(np.unique(cols_need))
    pair_rows = [[nd[(nd // k_loc) == s] for s in range(D)]
                 for nd in needs]
    pair_nnz = np.array([[int(b_len_h[pr].sum()) for pr in row]
                         for row in pair_rows])
    # round r moves pairs src -> dst=(src+r)%D; round 0 is the local
    # self-need. Each round pads to its own max.
    _round_max = [max(pair_nnz[(s + r) % D, s] for s in range(D))
                  for r in range(D)]
    round_nnz = [
        (int(mx) if pad_exact else int(_pow2ceil(int(mx)))) if mx > 0 else 0
        for mx in _round_max]
    seg_off = np.concatenate([[0], np.cumsum(round_nnz)])

    send_idx = [np.zeros((D, round_nnz[r]), np.int64) for r in range(D)]
    send_valid = [np.zeros((D, round_nnz[r]), bool) for r in range(D)]
    P_rows = int(_pow2ceil(max(1, max(
        len(pr) for row in pair_rows for pr in row))))
    RB = D * P_rows
    rb_start = np.zeros((D, RB), np.int32)
    rb_len = np.zeros((D, RB), np.int32)
    ax_remap = np.array(ax_h)
    spl_cols_remap = (np.array(ksp["spl_cols"]) if ksp is not None
                      else None)
    for src in range(D):
        for r in range(D):
            dst = (src + r) % D
            rows = pair_rows[dst][src]
            nz = int(b_len_h[rows].sum())
            if nz:
                pos = np.concatenate(
                    [np.arange(b_off[q], b_off[q + 1]) for q in rows])
                send_idx[r][src, :nz] = pos - b_off[src * k_loc]
                send_valid[r][src, :nz] = True
    for dst in range(D):
        lut = np.zeros(bsh.m, np.int64)
        for src in range(D):
            r = (dst - src) % D
            rows = pair_rows[dst][src]
            lens = b_len_h[rows]
            starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
            slots = src * P_rows + np.arange(len(rows))
            rb_start[dst, slots] = seg_off[r] + starts
            rb_len[dst, slots] = lens
            lut[rows] = slots
        ax_remap[dst] = lut[np.asarray(ax_h[dst], np.int64)]
        if spl_cols_remap is not None:
            spl_cols_remap[dst] = lut[
                np.asarray(ksp["spl_cols"][dst], np.int64)]
    if spl_cols_remap is not None:
        spl_cols_remap = np.asarray(spl_cols_remap, np.int32)

    def send_plans():
        return [(put(mesh, send_idx[r].astype(np.int32)),
                 put(mesh, send_valid[r]))
                for r in range(D) if round_nnz[r]]

    return (pair_nnz, round_nnz, put(mesh, rb_start), put(mesh, rb_len),
            put(mesh, ax_remap.astype(np.int32)), spl_cols_remap, send_plans)


class _AllgatherStep:
    """The allgather step: B's indptr and records gathered from every
    shard, each shard addressing global B row q at shard q // k_loc."""

    def __init__(self, body: _ShardBody, D: int, bnnz_max: int, CH: int,
                 f64: bool):
        self.body, self.D, self.bnnz_max = body, D, bnnz_max
        self.CH, self.f64 = CH, f64

    def __call__(self, mesh, ai, ax, ad, bi, bx, bd, wide_rid, *lv):
        g_indptr = all_gather(mesh, bi)                    # (D, k_loc+1)
        g_packed = all_gather(mesh, {d: _pack_payload(bx[d], bd[d],
                                                      self.f64)
                                     for d in mesh.local})
        D, bnnz_max = self.D, self.bnnz_max

        def inputs(d):
            gi = g_indptr[d]
            base = torch.arange(D, dtype=I32, device=gi.device)[:, None] \
                * bnnz_max
            b_start = (gi[:, :-1] + base).reshape(-1)
            b_len = (gi[:, 1:] - gi[:, :-1]).reshape(-1)
            return (ai[d], ax[d], ad[d], b_start, b_len,
                    g_packed[d].reshape(-1, self.CH), wide_rid[d],
                    *[x[d] for x in lv])

        return _assembled(mesh, self.body.run(mesh, inputs))


class _NeedsetStep:
    """The need-set step: per payload round, every src gathers the
    records its dst needs and one ppermute moves them (round 0, the
    self-need, moves nothing); the received segments concatenate into each
    shard's B payload, addressed through the remapped A columns."""

    def __init__(self, body: _ShardBody, payload_rounds, n_ladder: int,
                 CH: int, f64: bool):
        self.body, self.payload_rounds = body, list(payload_rounds)
        self.n_ladder, self.CH, self.f64 = n_ladder, CH, f64

    def __call__(self, mesh, ai, axr, ad, bx, bd, rbs, rbl, wide_rid,
                 *rest):
        lv = rest[: self.n_ladder - 1]
        sends = rest[self.n_ladder - 1:]
        packed = {d: _pack_payload(bx[d], bd[d], self.f64)
                  for d in mesh.local}
        segs = {d: [] for d in mesh.local}
        for i, r in enumerate(self.payload_rounds):
            sidx, sval = sends[2 * i], sends[2 * i + 1]
            payload = {}
            for d in mesh.local:
                pk = packed[d]
                p = pk[torch.clamp(sidx[d], 0, pk.shape[0] - 1)]
                payload[d] = torch.where(sval[d][:, None], p, 0)
            if r != 0:
                payload = ppermute(mesh, payload, r)
            for d in mesh.local:
                segs[d].append(payload[d])
        del packed
        b_payload = {d: (torch.cat(segs[d]) if segs[d] else torch.zeros(
            (1, self.CH), dtype=I32, device=mesh.devices[d]))
            for d in mesh.local}
        del segs

        def inputs(d):
            return (ai[d], axr[d], ad[d], rbs[d], rbl[d], b_payload[d],
                    wide_rid[d], *[x[d] for x in lv])

        return _assembled(mesh, self.body.run(mesh, inputs))


def _overlap_groups(ash_eff: RowShards, ops_sh: np.ndarray, a_ranges,
                    m_loc: int, k_loc: int, D: int, W: int, CP: int,
                    cfg: SpgemmConfig, n_cols: int):
    """The overlapped exchange's row groups: every row goes to the LAST
    exchange round its columns need (max over its nonzeros of (d - B
    owner) % D), so group r needs only the received rounds <= r and every
    row is computed once. Only rounds with a row of products are live.
    Returns (groups, host arrays): a group a live round (its ``round``,
    ``n_chunks``, ``rw_max`` and ladder ``specs``), and per group its row
    mask (D, m_loc), wide_rid and level maps, in the step's order."""
    masks = np.zeros((D, D, m_loc), bool)          # [round, shard, row]
    for d, sl in ash_eff.local.items():
        ip = np.asarray(sl.row_offsets, np.int64)
        rnd = (d - np.asarray(sl.col_ids, np.int64) // k_loc) % D
        rmax = np.zeros(sl.rows, np.int64)
        ne = ip[1:] > ip[:-1]
        if rnd.size:
            rmax[ne] = np.maximum.reduceat(rnd, ip[:-1][ne])
        masks[rmax, d, np.arange(sl.rows)] = True
    masks = _combine_max(masks.astype(np.uint8)).astype(bool)
    live = [r for r in range(D) if bool((masks[r] & (ops_sh > 0)).any())]
    groups, arrays = [], []
    for r in live or [0]:
        ops_list = [np.where(masks[r, d, : r1 - r0], ops_sh[d, : r1 - r0], 0)
                    for d, (r0, r1) in enumerate(a_ranges)]
        tqs = [tight_total_host(o, W, cfg.stream_min_q) for o in ops_list]
        rw_max, wide_rid, specs = _mesh_wide_plans(
            ops_list, W, cfg.stream_level_factor, cfg.stream_max_width,
            n_cols=n_cols)
        groups.append(dict(round=r, n_chunks=max(1, -(-max(tqs + [1]) // CP)),
                           rw_max=rw_max, specs=specs))
        arrays += [masks[r], wide_rid]
        for spec in specs:
            arrays += [spec["in_map"], spec["final"]]
    return groups, arrays


# the prefix of the overlapped exchange's profiler ranges, which mark its
# device work in a profile (probes/ab_overlap.py reads them)
EXCHANGE_LABEL = "needset_overlap exchange"


class _OverlapStep:
    """The overlapped need-set step. Every payload round's records are
    gathered and sent before any shard computes (``ppermute_start``);
    then, shard by shard, each row group runs once the rounds up to its
    own have landed. A shard's received buffer is one (RBT, CH) tensor
    written round by round at the round's offset; group r reads its
    prefix up to round r's end, which holds exactly the rounds <= r (the
    reference's chain of updated buffers, without a copy a round)."""

    def __init__(self, body: _ShardBody, payload_rounds, seg_off,
                 n_extras: int, CH: int, f64: bool):
        self.body, self.payload_rounds = body, list(payload_rounds)
        self.seg_off, self.n_extras = list(seg_off), n_extras
        self.CH, self.f64 = CH, f64

    def __call__(self, mesh, ai, axr, ad, bx, bd, rbs, rbl, *rest):
        ex = rest[: self.n_extras]
        sends = rest[self.n_extras:]
        packed = {d: _pack_payload(bx[d], bd[d], self.f64)
                  for d in mesh.local}
        issued = []
        for i, r in enumerate(self.payload_rounds):
            sidx, sval = sends[2 * i], sends[2 * i + 1]
            payload = {}
            with span(f"{EXCHANGE_LABEL} send round {r}"):
                for d in mesh.local:
                    pk = packed[d]
                    p = pk[torch.clamp(sidx[d], 0, pk.shape[0] - 1)]
                    payload[d] = torch.where(sval[d][:, None], p, 0)
                issued.append((r, ppermute_start(mesh, payload, r) if r
                               else payload))
        del packed
        seg_off = self.seg_off

        def prefix_of(d):
            """Shard d's received prefix of round r: its rounds <= r
            written into the buffer (waiting for each as it is first
            needed)."""
            buf = torch.zeros((max(seg_off[-1], 1), self.CH), dtype=I32,
                              device=mesh.devices[d])
            landed = set()

            def prefix(r):
                for pr, got in issued:
                    if pr <= r and pr not in landed:
                        with span(f"{EXCHANGE_LABEL} land round {pr}"):
                            part = got.wait(d) if pr else got[d]
                            buf[seg_off[pr]: seg_off[pr]
                                + part.shape[0]] = part
                        landed.add(pr)
                return buf[: max(seg_off[r + 1], 1)]
            return prefix

        def inputs(d):
            return (ai[d], axr[d], ad[d], rbs[d], rbl[d], prefix_of(d),
                    *[x[d] for x in ex])

        out = _assembled(mesh, self.body.run(mesh, inputs))
        # a round no group read still lands before the step returns
        for pr, got in issued:
            if pr:
                for d in mesh.local:
                    got.wait(d)
        return out


def _assembled(mesh, out):
    nnz_row, cols, vals = out
    return assemble(mesh, nnz_row), assemble(mesh, cols), assemble(mesh, vals)


# ---- step cache (mesh plan reuse) -----------------------------------------
# Repeated multiplies whose HOST plan has the same static signature (same
# shard shapes, chunk/ladder/exchange-round layout, cfg, mesh) reuse the
# SAME step object. Every step is arg-complete: all structure-dependent
# arrays (indptrs, col ids, remaps, ladder in_maps, exchange tables, send
# plans) ride the argument list, so two plans with equal static keys run
# the same computation. Bounded LRU; meta["compiled_reused"] reports a hit.

_step_cache: "OrderedDict" = OrderedDict()
_STEP_CACHE_CAP = 8
_last_exec = None


def _specs_key(specs):
    return tuple((s["F"], s["W_in"], s["R_out"], s["in_map"].shape,
                  s.get("W_buf_in"), s.get("W_buf_out")) for s in specs)


def _argsig(args, D: int):
    """Shape/dtype signature of a per-shard argument tuple (global shapes:
    the shard count, then one shard's shape)."""
    sig = []
    for x in args:
        part = next(iter(x.values()))
        sig.append(((D,) + tuple(part.shape), str(part.dtype)))
    return tuple(sig)


def _cached_step(key, build):
    """Return (step, reused: bool) for the given static key."""
    fn = _step_cache.get(key)
    if fn is not None:
        _step_cache.move_to_end(key)
        return fn, True
    fn = build()
    _step_cache[key] = fn
    while len(_step_cache) > _STEP_CACHE_CAP:
        _step_cache.popitem(last=False)
    return fn, False


def _set_last_exec(fn, args):
    global _last_exec
    _last_exec = (fn, args)


def last_exec():
    """The (step, arguments) of the most recent mesh_stream_spgemm
    dispatch; ``fn(*args)`` runs the per-shard step again without host
    planning (the arguments start with the mesh)."""
    return _last_exec


def _ksplit_meta(ksp) -> Optional[dict]:
    """Plan summary in meta, so callers can assert the single-row
    sharding engaged."""
    if ksp is None:
        return None
    return dict(n_split=int(ksp["n_split"]), n_rows=int(ksp["n_rows"]),
                max_parts=int(ksp["max_parts"]),
                split_ids=np.asarray(ksp["split_ids"]).tolist())


def mesh_stream_to_host_csr(nnz_row, cols, vals, meta) -> HostCSR:
    """Assemble the padded per-shard outputs into one HostCSR (every
    process gets the full matrix)."""
    m, n = meta["shape"]
    m_loc, out_cap = meta["m_loc"], meta["out_cap"]
    nnz_row = fetch_output(nnz_row).reshape(-1, m_loc)
    cols = fetch_output(cols).reshape(-1, out_cap)
    vals = fetch_output(vals).reshape(-1, out_cap)
    parts_c, parts_v, counts = [], [], []
    for d, (r0, r1) in enumerate(meta["ranges"]):
        cnt = nnz_row[d][: r1 - r0]
        tot = int(cnt.sum())
        parts_c.append(cols[d][:tot])
        parts_v.append(vals[d][:tot])
        counts.append(cnt)
    cnt_all = np.concatenate(counts) if counts else np.zeros(0, np.int64)
    offsets = np.zeros(m + 1, np.int64)
    if cnt_all.shape[0]:
        np.cumsum(cnt_all, out=offsets[1:1 + cnt_all.shape[0]])
        offsets[1 + cnt_all.shape[0]:] = offsets[cnt_all.shape[0]]
    return HostCSR(
        rows=m, cols=n, row_offsets=offsets,
        col_ids=(np.concatenate(parts_c) if parts_c
                 else np.zeros(0, np.int64)),
        data=(np.concatenate(parts_v) if parts_v else np.zeros(0)),
    )
