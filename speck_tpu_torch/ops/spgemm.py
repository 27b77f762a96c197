"""SpGEMM orchestrator (torch port of ``speck_tpu/ops/spgemm.py``): the
product-stream, direct-copy, dense-tile, accumulator and diagonal-plane
routes.

Stages (stage names as in the reference's timings):

  1. analysis     host numpy (HostCSR attached) or ops/analysis.analyze
  2. planning     the routing gates, then stream.plan_device_stream: one
                  device pass, ONE readback
  3. counting     the dense tiles (dense.dense_tiles), one fused
                  count-and-stage pass per (G, W) chunk
                  (stream.stream_chunk: the chunk step, stream.chunk_sorted,
                  over the plan's ``ChunkRecords``), the accumulator
                  (_run_accum)
  4. wide rows    merge levels + the wide finish (_run_wide), with one
                  small readback of the wide rows' entry totals
  5. offsets      cumsum + ONE readback of nnz and the widest row
  6. emission     gather emit of the staged chunks (or of the dense
                  tiles when they cover every row), or the two-phase
                  numeric chunks; dense, wide, accumulator and direct
                  rows scatter

Each stage is a ``StageTimer`` and, while ``torch.profiler`` is on, the
range ``speck.<stage>`` (utils/timings.py); inside them the sub-ranges

  countProducts        speck.plan.host_analyze
  loadBalanceCounting  speck.plan.lite_gate.<step>, speck.plan.host_gates.
                       <step> (the gates' steps by their names),
                       speck.plan.device_plan (plan_stream),
                       speck.plan.host_layout, speck.plan.groups (the
                       direct and dense groups), speck.plan.records
                       (stream_records, build_srec)
                       and in both, inside the first step that reads them,
                       speck.plan.row_ends (the host copies' row ends,
                       analysis.HostEnds, once a call)
  spGEMMCounting       speck.count.chunk (one a chunk), speck.wide.level
                       (one a merge level), speck.wide.finish (one a
                       finish class), speck.accum, speck.dense.batch
  allocC               speck.alloc.compact (the raw chunks' compaction)
  spGEMMNumeric        speck.numeric.chunk (one a chunk), speck.wide.level,
                       speck.wide.finish, speck.accum, speck.dense.batch,
                       speck.emit, speck.direct

and ``speck.readback.<what>`` around each readback, and
``speck.values.by_slot`` around each gather of a 16- or 64-bit value plane
after a sort (``bitonic.by_slot``, counted in ``bitonic.BY_SLOT``). A plan
marks its route by the zero-length range ``speck.route.<route>`` and
counts it in ``ROUTES``. The sub-ranges add nothing to a ``Timings``;
none of them synchronizes.

Row routing as the reference's: a matrix whose diagonal band passes the
gates runs whole over diagonal planes (ops/dia.py: contiguous DIA over a
band, ``_plan_dia``; sparse DIA over present-offset lists, ``_plan_sdia``;
planes, convolution and staging in counting, the meta readback in allocC,
the emit in numeric); otherwise the per-row DIA split (``DiaRowGroup``)
takes the banded bulk, dense-eligible row tiles take window products
(``DenseGroup``, ops/dense.py), huge rows of bounded output span take the
accumulator (``cfg.enable_accum``), and the rest stream or copy.

It keeps exactly the reference's host readbacks (the planning pack or the
early gate, the wide-row totals, the nnz and widest row; on the DIA routes
the diagonal bitmap and the meta) and adds none: no boolean-mask
indexing, ``.nonzero()`` or ``.item()`` on the device path. Each goes
through ``utils.timings.readback``, which counts it; host arrays go to the
device through ``utils.timings.upload``, which does not synchronize, so
the readbacks are a call's only synchronizing copies.

The kernels' launch counters take each launch's live slots where the host
holds them without a readback (``live``): a chunk's share of the stream's
products (``stream_products``, ``chunk_live``), a merge level's and a
finish class's entries (read with the wide rows' totals). The chunks'
compactions carry none.

Values of float16, bfloat16, float32 and float64, alike or mixed, run
as in the reference: a float32 A packs B's values as float32 on the
stream (float32 out); a 16-bit or float64 A takes the unpacked B gathers
(``expand.Unpacked``) and the products' promoted type (bfloat16 times
float32 is float32). Where the reference raises, the port raises
TypeError: the dense tiles of a float32 A times a B of another type (the
packed record, ``esc.pack_csr_arrays``) and the contiguous diagonal
convolution of an A narrower than the products (``dia.dia_conv``). A call
past ``block_products`` runs as row blocks (``_spgemm_blocked``). The
reference's A/B knobs all run (ops/stream.py): every ``stream_expand_impl``
and ``stream_sort_impl`` name runs the one expand (K4 on a CUDA device)
and the one row sort (K2); ``check_knobs`` raises ValueError only for
values the reference does not name. The contract and the row sorts
always run the hand-written kernels on a CUDA device (ops/contract.py,
ops/bitonic.py).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.config import ProductOverflow, SpgemmConfig
from ..utils.timings import (StageTimer, Timings, host_pass, readback,
                             span, sync_tensors, upload)
from .analysis import (HostEnds, analyze, cumsum1d, host_analyze,
                       host_band_extremes, host_gate_lite)
from .contract import VALUE_DTYPES
from .dense import dense_emit, dense_gather_emit, dense_tiles
from .device_csr import DeviceCSR, host_of
from .dia import (
    DiaState,
    dia_conv,
    dia_count_pipeline,
    dia_count_stage,
    dia_emit_edge,
    dia_numeric_stage,
    dia_offsets_meta,
    dia_planes,
    dia_row_inband,
    dia_rows_conv_fused,
    dia_scatter_emit,
    dia_slots,
    plane_bytes,
    row_ids,
    sdia_conv,
    sdia_lut,
    sdia_pad,
    sdia_plane_bytes,
    sdia_slots,
)
from .esc import direct_chunk, pack_csr_arrays, packable
from .expand import Unpacked
from .stream import (
    COMPACT_IMPLS,
    EXPAND_IMPLS,
    N_QCLASS,
    SORT_IMPLS,
    N_WSEG_PACK,
    ChunkRecords,
    LevelPlan,
    StreamLayout,
    accum_finalize,
    build_srec,
    compact_staged,
    plan_device_stream,
    plan_gate,
    plan_layout,
    plan_levels,
    stream_chunk,
    stream_chunk_accum,
    stream_chunk_numeric,
    stream_emit,
    stream_gather_emit,
    stream_level,
    stream_wide_finish,
    wide_entry_totals,
)

I32 = torch.int32

# plans made in this process by route: "dia", "sdia", "stream", "dense"
# (every row in the dense tiles), "empty"; "blocked" counts the calls
# that ran as row blocks, whose blocks count their own plans
ROUTES: Dict[str, int] = {}


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _bucket_rows(count: int, full: int) -> int:
    """Direct-chunk row count: the budget-limited size for populous
    classes, else the next power of 4 >= count."""
    if count >= full:
        return full
    pow4 = 1 << (((count - 1).bit_length() + 1) // 2 * 2) if count > 1 else 1
    return max(1, min(full, pow4))


def check_supported(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR) -> None:
    """Raise TypeError for value types that are not floating point of 16,
    32 or 64 bits (each operand may have its own), and check the knobs."""
    for X in (A, B):
        if X.data.dtype not in VALUE_DTYPES:
            raise TypeError(f"values must be float16, bfloat16, float32 or "
                            f"float64, not {X.data.dtype}")
    check_knobs(cfg)


def check_knobs(cfg: SpgemmConfig) -> None:
    """Raise ValueError for an A/B knob value that the reference does not
    name, or a merge-level factor below 2 (the reference's ladder never
    ends there); the mesh checks them too."""
    for name, allowed in (("stream_sort_impl", SORT_IMPLS),
                          ("stream_compact_impl", COMPACT_IMPLS),
                          ("stream_expand_impl", EXPAND_IMPLS)):
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"{name}={getattr(cfg, name)!r}: one of "
                             f"{', '.join(allowed)}")
    if cfg.stream_level_factor < 2:
        raise ValueError(f"stream_level_factor={cfg.stream_level_factor}: "
                         "merge levels need a factor of at least 2")


@dataclasses.dataclass(frozen=True)
class DenseGroup:
    """Dense-eligible row tiles (ops/dense.py) in dispatch batches: batch b
    covers tiles [boffs[b], boffs[b + 1]) of the padded tile arrays (on
    the device; only their count crossed to the host). Tile i covers rows
    [r0s[i], r0s[i] + valids[i]). kw, cw, la and lb are the effective
    windows, fitted to the eligible tiles (a class ladder; the config
    values are only ceilings). full_cover: every row tile is eligible, so
    tile i covers rows [i * tile_rows, ...) in order (the gather emit's
    precondition)."""

    r0s: torch.Tensor
    kbases: torch.Tensor
    cbases: torch.Tensor
    valids: torch.Tensor
    boffs: List[int]
    tile_rows: int
    kw: int
    cw: int
    la: int
    lb: int
    full_cover: bool = False

    @property
    def staging_slots(self) -> int:
        return len(self.r0s) * self.tile_rows * self.cw

    def batches(self):
        for b in range(len(self.boffs) - 1):
            s, e = self.boffs[b], self.boffs[b + 1]
            yield (self.r0s[s:e], self.kbases[s:e], self.cbases[s:e],
                   self.valids[s:e])


@dataclasses.dataclass(frozen=True)
class DirectGroup:
    """Fixed-shape chunks of one direct-copy class (single-A-nonzero rows):
    chunk c covers rows_sorted[starts[c]: starts[c] + rows], the first
    valids[c] live, copy capacity ``cap``."""

    cap: int
    rows: int
    starts: np.ndarray
    valids: np.ndarray


@dataclasses.dataclass
class StreamState:
    """Device and host state of the stream route, kept on the plan."""

    layout: StreamLayout
    lplans: List[LevelPlan]
    rows_sorted: torch.Tensor   # (m,) sorted by descending products
    rows_padded: torch.Tensor   # rows_sorted padded for direct slicing
    e: torch.Tensor             # (m,) stream starts
    q_sorted: torch.Tensor      # (m,) product quantum per sorted row
    el: torch.Tensor            # (m,) exclusive live-ops prefix
    ops_sorted: torch.Tensor    # (m,) live products per sorted row
    rec: ChunkRecords           # the chunks' records, B unbound
    fused: bool
    # the products the chunks hold, where the host has them without a
    # readback (``stream_products``): the kernels' live slots
    products: Optional[int] = None
    staged: Optional[list] = None       # per-chunk (rid, col, val, counts)
    level_bufs: Optional[list] = None   # per-level (rid, col, val, counts)
    wide_rid_in: Optional[torch.Tensor] = None
    wide_rid_in_h: Optional[np.ndarray] = None
    # wide-finish decision of the counting pass, replayed by numeric
    finish: Optional[dict] = None
    # concatenated staged (cols, vals), cached for repeated execute()
    staged_flat: Optional[tuple] = None
    # dense-eligible tiles the planning pass counted, None where the host
    # pre-reject left the count off
    dense_elig: Optional[int] = None
    # the accumulator region (huge rows of bounded output span, sorted
    # first): its product space's records and host part plan
    n_accum: int = 0
    rec2: Optional[ChunkRecords] = None
    cmin_s: Optional[torch.Tensor] = None   # (m,) first output column
    abase: Optional[torch.Tensor] = None    # part-local accumulator bases
    accum: Optional[dict] = None            # the host part plan: parts
    accum_bufs: Optional[list] = None       # staged finalize outputs

    @property
    def pack_bits(self) -> int:
        return self.rec.pack_bits

    def staged_cat(self):
        """The staged chunks' columns and values, each concatenated once
        (the gather emit's input, kept for repeated execute())."""
        if self.staged_flat is None:
            self.staged_flat = (
                torch.cat([s[1].reshape(-1) for s in self.staged]),
                torch.cat([s[2].reshape(-1) for s in self.staged]))
        return self.staged_flat


@dataclasses.dataclass
class DiaRowGroup:
    """Per-row DIA split state (cfg.dia_rows): the banded bulk of a matrix
    whose whole-matrix DIA gate failed rides diagonal planes, the other
    rows ride the stream and direct routes. Each C row is produced by one
    route (a row qualifies only if every B row it touches is in band), so
    the planes' entries scatter into the shared C."""

    span_a: int
    span_b: int
    span_c: int
    dmin_a: int
    dmin_b: int
    slot_a: torch.Tensor     # (nnz_a,) masked plane slots (DIA rows only)
    slot_b: torch.Tensor     # (nnz_b,) masked plane slots (in-band B rows)
    present: torch.Tensor    # (m, span_c) structural presence
    cvT: Optional[torch.Tensor] = None   # staged (m, span_c) value plane


@dataclasses.dataclass
class SpgemmPlan:
    """Symbolic result of C = A @ B, reusable across numeric runs."""

    A: DeviceCSR
    B: DeviceCSR
    cfg: SpgemmConfig
    row_offsets: torch.Tensor   # (m+1,) int32
    nnz: int
    sum_products: object        # () float
    stream: Optional[StreamState] = None
    groups: List[DirectGroup] = dataclasses.field(default_factory=list)
    dense: Optional[DenseGroup] = None
    dense_staged: Optional[List[tuple]] = None
    max_count: int = 0
    dia: Optional[DiaState] = None
    dia_rows: Optional[DiaRowGroup] = None

    @property
    def shape(self):
        return (self.A.shape[0], self.B.shape[1])

    def execute(self, A: Optional[DeviceCSR] = None,
                B: Optional[DeviceCSR] = None,
                timings: Optional[Timings] = None) -> DeviceCSR:
        """Numeric phase: C's columns and values at exact offsets. A/B may
        carry new ``data`` on the plan's structure."""
        use_staged = A is None and B is None
        A = self.A if A is None else A
        B = self.B if B is None else B
        check_supported(self.cfg, A, B)
        m, n = self.shape
        dev = self.row_offsets.device
        track = timings is not None and timings.measure_all
        if self.dia is not None:
            return self._execute_dia(A, B, use_staged, timings, track)
        total = max(self.nnz, 1)
        ss = self.stream
        d = self.dense
        # every row in a dense tile, staged: C by gather from the tiles
        if (d is not None and use_staged and self.dense_staged is not None
                and not self.groups and d.full_cover and self.nnz > 0
                and (ss is None or ss.layout.n_stream_rows == 0)):
            with StageTimer(timings, "spGEMMNumeric", track) as st, \
                    span("speck.emit"):
                if len(self.dense_staged) == 1:
                    _, cols_c, vals_c = self.dense_staged[0]
                else:
                    cols_c = torch.cat([x[1].reshape(-1, d.cw)
                                        for x in self.dense_staged])
                    vals_c = torch.cat([x[2].reshape(-1, d.cw)
                                        for x in self.dense_staged])
                c_cols, c_vals = dense_gather_emit(
                    cols_c, vals_c, self.row_offsets, tile_rows=d.tile_rows,
                    cw=d.cw, m=m, nnz=self.nnz)
                st.stop(c_cols, c_vals)
            return DeviceCSR(indptr=self.row_offsets, indices=c_cols,
                             data=c_vals, shape=(m, n), nnz=self.nnz)
        gather_emit = (use_staged and ss is not None and ss.fused
                       and ss.staged is not None and ss.layout.total_q > 0
                       and self.nnz > 0)
        with StageTimer(timings, "spGEMMNumeric", track) as st:
            if gather_emit:
                # contained stream rows by gather over the concatenated
                # staged buffers; wide and direct rows overwrite theirs
                with span("speck.emit"):
                    c_cols, c_vals = stream_gather_emit(
                        ss.rows_sorted, ss.e, self.row_offsets,
                        *ss.staged_cat(), W=ss.layout.W, nnz=self.nnz)
            else:
                # one trailing slot takes the dropped scatter writes
                c_cols = torch.zeros(total + 1, dtype=I32, device=dev)
                c_vals = torch.zeros(total + 1, dtype=c_value_dtype(A, B),
                                     device=dev)
            if d is not None:
                staged = use_staged and self.dense_staged is not None
                if not staged:
                    apk, bpk = _dense_operands(A, B)
                for bi, (r0s, kbs, cbs, _) in enumerate(d.batches()):
                    with span("speck.dense.batch"):
                        if staged:
                            counts, cols_c, vals_c = self.dense_staged[bi]
                        else:
                            _, (counts, cols_c, vals_c) = dense_tiles(
                                r0s, kbs, cbs, A.indptr, A.indices, A.data,
                                B.indptr, B.indices, B.data,
                                torch.zeros(m + 1, dtype=I32, device=dev),
                                apk, bpk, tile_rows=d.tile_rows, kw=d.kw,
                                cw=d.cw, la=d.la, lb=d.lb, m=m,
                                k_dim=A.shape[1], n_cols=n,
                                densify=self.cfg.dense_densify)
                        c_cols, c_vals = dense_emit(
                            r0s, counts, cols_c, vals_c, self.row_offsets,
                            c_cols, c_vals, tile_rows=d.tile_rows, cw=d.cw,
                            m=m, emit_cap=_pow2(self.max_count))
            if (ss is not None and ss.layout.n_chunks > 0
                    and ss.layout.total_q > 0):
                lo = ss.layout
                compact_impl = self.cfg.stream_compact_impl
                if use_staged and ss.fused and ss.staged is not None:
                    level_bufs = ss.level_bufs or []
                else:
                    rec = _stream_operands(A, B, ss.rec, new_values=True)
                    # a two-phase plan merged its wide values at plan time
                    reuse_levels = bool(use_staged and not ss.fused
                                        and ss.level_bufs)
                    wide_staged = []
                    for c in range(lo.n_chunks):
                        has_wide = (c * lo.G < lo.r_wide) and not reuse_levels
                        with span("speck.numeric.chunk"):
                            c_cols, c_vals, stg = stream_chunk_numeric(
                                rec, c, ss.rows_sorted, self.row_offsets,
                                c_cols, c_vals, ss.n_accum + lo.n_wide,
                                stage_wide=has_wide,
                                compact_impl=compact_impl,
                                live=chunk_live(lo, ss.products, c))
                        if stg is not None:
                            wide_staged.append(stg)
                    if reuse_levels:
                        level_bufs = ss.level_bufs
                    else:
                        level_bufs = _run_wide(
                            ss, wide_staged, None, n, count=False,
                            max_width=self.cfg.stream_max_width,
                            compact_impl=compact_impl)[1]
                with span("speck.emit"):
                    for rid_out, col_c, val_c, fcnt in level_bufs:
                        rid_b = rid_out[:, None].expand(col_c.shape)
                        c_cols, c_vals = stream_emit(
                            ss.rows_sorted, rid_b, col_c, val_c, fcnt,
                            self.row_offsets, c_cols, c_vals)
            if ss is not None and ss.accum:
                if use_staged and ss.accum_bufs is not None:
                    accum_bufs = ss.accum_bufs
                else:
                    with span("speck.accum"):
                        accum_bufs = _run_accum(ss, A, B, None, count=False,
                                                new_values=True)[1]
                with span("speck.emit"):
                    for rid_out, col_c, val_c, fcnt in accum_bufs:
                        rid_b = rid_out[:, None].expand(col_c.shape)
                        c_cols, c_vals = stream_emit(
                            ss.rows_sorted, rid_b, col_c, val_c, fcnt,
                            self.row_offsets, c_cols, c_vals)
            with span("speck.direct"):
                for g in self.groups:
                    for start, valid in zip(g.starts, g.valids):
                        if valid == 0:
                            continue
                        c_cols, c_vals = direct_chunk(
                            ss.rows_padded, int(start), int(valid),
                            A.indptr, A.indices, A.data, B.indptr,
                            B.indices, B.data, self.row_offsets, c_cols,
                            c_vals, chunk_rows=g.rows, cap=g.cap)
            if self.dia_rows is not None:
                dg = self.dia_rows
                if use_staged and dg.cvT is not None:
                    cvT = dg.cvT
                else:
                    # new values: value planes from the stored (masked)
                    # slots, convolved again
                    c_val, _ = dia_rows_conv_fused(
                        dg.slot_a, A.data, dg.slot_b, B.data, sa=dg.span_a,
                        sb=dg.span_b, m=m, k=A.shape[1], dmin_a=dg.dmin_a,
                        with_hit=False)
                    cvT = c_val.t()
                with span("speck.emit"):
                    c_cols, c_vals = dia_scatter_emit(
                        cvT, dg.present, self.row_offsets, c_cols, c_vals,
                        base_c=dg.dmin_a + dg.dmin_b)
            st.stop(c_cols, c_vals)
        return DeviceCSR(indptr=self.row_offsets, indices=c_cols[:total],
                         data=c_vals[:total], shape=(m, n), nnz=self.nnz)

    def _execute_dia(self, A, B, use_staged, timings, track) -> DeviceCSR:
        """Numeric phase of a DIA-routed plan: the staged planes emit
        directly; new values rebuild the value planes and stage again
        against the stored structural presence."""
        d = self.dia
        m, n = self.shape
        k = A.shape[1]
        base_c = d.dmin_a + d.dmin_b
        with StageTimer(timings, "spGEMMNumeric", track) as st:
            if use_staged and d.staged is not None:
                cols_s, vals_s = d.staged
            else:
                av, ah = dia_planes(d.slot_a, A.data, span=d.span_a, rows=m)
                if (B.indices is A.indices and B.data is A.data
                        and B.shape == A.shape):
                    bv, bh = av, ah
                else:
                    bv, bh = dia_planes(d.slot_b, B.data, span=d.span_b,
                                        rows=k)
                if d.off_a is not None:
                    off_c = tuple(sorted({a + b for a in d.off_a
                                          for b in d.off_b}))
                    c_val, _ = sdia_conv(av, ah, bv, bh, off_a=d.off_a,
                                         off_b=d.off_b, off_c=off_c, m=m,
                                         k=k, with_hit=False)
                    cols_s, vals_s = dia_numeric_stage(
                        c_val, d.present, d.doffs, sc=d.span_c, m=m,
                        n_cols=n, base_c=0)
                else:
                    c_val, _ = dia_conv(av, ah, bv, bh, sa=d.span_a,
                                        sb=d.span_b, m=m, k=k,
                                        dmin_a=d.dmin_a, with_hit=False)
                    cols_s, vals_s = dia_numeric_stage(
                        c_val, d.present, sc=d.span_c, m=m, n_cols=n,
                        base_c=base_c)
            if self.nnz > 0 and d.uniform is not None:
                # the all-full interior block is the final payload at a
                # constant shift: one contiguous copy; only the
                # band-clipped edge rows gather
                up, uq, u_offs = d.uniform
                sc = d.span_c
                mid_n = (uq - up) * sc
                parts_c, parts_v = [], []
                if u_offs > 0:
                    ec, ev = dia_emit_edge(cols_s, vals_s, self.row_offsets,
                                           sc=sc, r0=0, r1=up, o0=0,
                                           n_out=u_offs)
                    parts_c.append(ec)
                    parts_v.append(ev)
                parts_c.append(cols_s.reshape(-1)[up * sc: uq * sc])
                parts_v.append(vals_s.reshape(-1)[up * sc: uq * sc])
                tail_n = self.nnz - u_offs - mid_n
                if tail_n > 0:
                    ec, ev = dia_emit_edge(cols_s, vals_s, self.row_offsets,
                                           sc=sc, r0=uq, r1=m,
                                           o0=u_offs + mid_n, n_out=tail_n)
                    parts_c.append(ec)
                    parts_v.append(ev)
                c_cols = torch.cat(parts_c)
                c_vals = torch.cat(parts_v)
            elif self.nnz > 0:
                c_cols, c_vals = dense_gather_emit(
                    cols_s, vals_s, self.row_offsets, tile_rows=1,
                    cw=d.span_c, m=m, nnz=self.nnz)
            else:
                c_cols = torch.zeros(1, dtype=I32, device=A.device)
                c_vals = torch.zeros(1, dtype=A.data.dtype, device=A.device)
            st.stop(c_cols, c_vals)
        return DeviceCSR(indptr=self.row_offsets, indices=c_cols,
                         data=c_vals, shape=(m, n), nnz=self.nnz)


def _stream_operands(A: DeviceCSR, B: DeviceCSR, rec: ChunkRecords,
                     new_values: bool = False) -> ChunkRecords:
    """``rec`` with the expand's record channel and B operand of A and B:
    for a float32 A, A's value bits (the plan's, or with ``new_values``
    gathered again through the A-source map) and the packed (col, value
    bits) B record with B's values cast to float32, as the reference
    packs them; for any other A, the A-source map itself and the unpacked
    operands (the reference's branch on ``packable``)."""
    if packable(A.data):
        sa = (A.data.contiguous().view(I32)[rec.src] if new_values
              else rec.sa)
        return rec._replace(sa=sa, b=pack_csr_arrays(
            B.indices, B.data.to(torch.float32)))
    return rec._replace(sa=rec.src, b=Unpacked(A.data, B.indices, B.data))


def c_value_dtype(A: DeviceCSR, B: DeviceCSR) -> torch.dtype:
    """C's value type on every path: the fused stream's, whose products
    are float32 for a float32 A (B packed as float32) and of the promoted
    type for any other A. The reference emits the two-phase and
    new-value paths in A's type and sums the accumulator in A's type;
    the port holds them to this one type (ROADMAP.md Queue 3, standing
    decision 10)."""
    if packable(A.data):
        return torch.float32
    return torch.promote_types(A.data.dtype, B.data.dtype)


def _dense_operands(A: DeviceCSR, B: DeviceCSR):
    """The dense tiles' packed (col, value bits) records of A and B
    (shared when B is A), or (None, None) for an A of 16 or 64 bits,
    whose tiles gather unpacked. A float32 A packs B as it is, so a B of
    another type raises TypeError there, as in the reference."""
    if not packable(A.data):
        return None, None
    apk = pack_csr_arrays(A.indices, A.data)
    if B.indices is A.indices and B.data is A.data:
        return apk, apk
    return apk, pack_csr_arrays(B.indices, B.data)


def count_chunk(ss: StreamState, rec: ChunkRecords, nnz_row, c: int,
                compact_impl: str):
    """Chunk c of the counting loop (``stream_chunk``: the chunk step, the
    rows' counts into ``nnz_row``), staged where the plan keeps it: a
    chunk with wide rows compacted, every chunk of a fused plan, the
    contained-only ones raw (sorted, uncompacted; compaction runs only if
    C has duplicates). ``rec`` is the plan's bundle with its operands
    bound (``_stream_operands``). Returns (nnz_row, staged)."""
    lo = ss.layout
    has_wide = c * lo.G < lo.r_wide
    return stream_chunk(
        rec, c, ss.rows_sorted, ss.q_sorted, ss.el, ss.ops_sorted, nnz_row,
        stage=ss.fused or has_wide, stage_raw=ss.fused and not has_wide,
        compact_impl=compact_impl, live=chunk_live(lo, ss.products, c))


def stream_products(pk: PlanPack, hg, direct_ok: bool) -> Optional[int]:
    """The products the stream's chunks hold, where the host has them
    without a readback: the pack's exact total when no row takes another
    route, or, with the host analysis ``hg``, that total less the direct
    rows' (a row of one A nonzero); else None."""
    if pk.dense[0] or pk.dia_band[4] or pk.a_hist.any():
        return None
    sp_exact = pk.gate[6]
    if not pk.d_hist.any():
        return sp_exact
    if hg is None or not direct_ok:
        return None
    return sp_exact - int(np.asarray(hg.row_ops)[hg.a_len == 1].sum())


def chunk_live(lo: StreamLayout, products: Optional[int], c: int
               ) -> Optional[int]:
    """Chunk c's live slots: the stream's ``products`` in proportion to
    the chunk's slots of the stream, so that they sum exactly over the
    chunks (None without ``products``)."""
    if products is None:
        return None
    start = c * lo.G * lo.W
    rows = lo.g_last if c == lo.n_chunks - 1 else lo.G
    end = min(start + rows * lo.W, lo.total_q)
    return products * end // lo.total_q - products * start // lo.total_q


def _offsets_from_counts(nnz_row: torch.Tensor):
    """Row offsets (int32, nnz(C) last) and the meta [nnz(C), widest row]
    for the one readback."""
    zero = torch.zeros(1, dtype=I32, device=nnz_row.device)
    offs = torch.cat([zero, cumsum1d(nnz_row)])
    return offs, torch.stack([offs[-1], torch.amax(nnz_row)])


def _wide_slices(ss: StreamState, wide_staged):
    lo = ss.layout
    G = lo.G
    take = [min(G, lo.r_wide - i * G) for i in range(len(wide_staged))]
    return tuple(torch.cat([s[k][:t] for s, t in zip(wide_staged, take)])
                 for k in (1, 2, 3))


def _finish_classes(totals: np.ndarray, rid_live: np.ndarray, device):
    """Lay out the wide finish: rows bucketed by pow2(entry total) so one
    oversized row does not widen every row's sort. ``totals`` are per-
    live-row entry counts in buffer (ascending rid) order."""
    entry_excl = np.concatenate([[0], np.cumsum(totals)])[:-1]
    e_total = int(totals.sum())
    E_pad = _pow2(max(e_total, 2))
    classes = {}
    for i, tot in enumerate(totals):
        classes.setdefault(_pow2(max(int(tot), 8)), []).append(i)
    out = []
    for W2, idxs in sorted(classes.items(), reverse=True):
        R2 = _pow2(len(idxs))
        rid = np.full(R2, -1, np.int32)
        rid[: len(idxs)] = rid_live[idxs]
        ee = np.full(R2, e_total, np.int32)
        ee[: len(idxs)] = entry_excl[idxs]
        rt = np.zeros(R2, np.int32)
        rt[: len(idxs)] = totals[idxs]
        out.append(dict(
            R2=R2, W2=W2, E_pad=E_pad, live=int(totals[idxs].sum()),
            entry_excl=upload(ee, device), row_total=upload(rt, device),
            rid_of_out=upload(rid, device)))
    return out


def _run_wide(ss: StreamState, wide_staged, nnz_row, n_cols: int,
              count: bool, max_width: int, compact_impl: str = "sort"):
    """Finish the wide rows: merge levels until every remaining row's
    deduplicated entry total fits ``max_width`` (one small readback of
    the totals per level while deciding), then one sort at each row's
    true entry width. The counting pass records the decision in
    ss.finish; the numeric pass replays it without readbacks. Returns
    (nnz_row, staged buffers to emit). Each level's and each finish
    class's entries, read with the totals, are their launches' live
    slots (kept in ss.finish for the replay)."""
    lo = ss.layout
    if lo.n_wide == 0 or not wide_staged:
        return nnz_row, []
    dev = ss.rows_sorted.device
    if nnz_row is None:
        nnz_row = torch.zeros(ss.rows_sorted.shape[0] + 1, dtype=I32,
                              device=dev)
        count = False
    wcol, wval, wcnt = _wide_slices(ss, wide_staged)
    rid_in, rid_in_h = ss.wide_rid_in, ss.wide_rid_in_h
    # rids are sorted-row ids; the accumulator rows sort first, so the
    # wide rows' segment ids start at n_accum
    na = ss.n_accum
    W_in = lo.W
    deciding = ss.finish is None
    if deciding:
        ss.finish = dict(ladder_levels=len(ss.lplans), classes=None,
                         W_in=W_in, live=[])
    bufs = []
    li = 0
    while True:
        if deciding:
            totals = wide_entry_totals(wcnt, rid_in - na, n_wide=lo.n_wide)
            totals = readback(totals, "wide_totals").astype(np.int64)
            ss.finish["live"].append(int(totals.sum()))
            live_loc = np.unique(rid_in_h) - na
            live_tot = totals[live_loc]
            keep_live = live_tot > 0
            live_loc, live_tot = live_loc[keep_live], live_tot[keep_live]
            if live_tot.size == 0:
                ss.finish.update(ladder_levels=li, classes=[])
                break
            if _pow2(int(live_tot.max())) <= max_width:
                ss.finish.update(
                    ladder_levels=li, W_in=W_in,
                    classes=_finish_classes(live_tot, live_loc + na, dev))
                deciding = False
        if not deciding and li >= ss.finish["ladder_levels"]:
            classes = ss.finish["classes"]
            if classes is not None:
                wc_flat = wcol.reshape(-1)
                wv_flat = wval.reshape(-1)
                for f in classes:
                    with span("speck.wide.finish"):
                        nnz_row, buf = stream_wide_finish(
                            ss.rows_sorted, wc_flat, wv_flat, wcnt,
                            f["entry_excl"], f["row_total"], f["rid_of_out"],
                            nnz_row, R2=f["R2"], W2=f["W2"],
                            W0=ss.finish["W_in"], E_pad=f["E_pad"],
                            n_cols=n_cols, count=count,
                            compact_impl=compact_impl, live=f["live"])
                    bufs.append(buf)
            break
        if li >= len(ss.lplans):
            break
        lp = ss.lplans[li]
        with span("speck.wide.level"):
            nnz_row, (rid_out, col_c, val_c, counts) = stream_level(
                ss.rows_sorted, rid_in, wcol, wval, wcnt,
                upload(lp.in_map, dev), upload(lp.final_mask, dev),
                nnz_row, F=lp.F, W_in=lp.W_in, n_cols=n_cols, count=count,
                compact_impl=compact_impl, live=ss.finish["live"][li])
        # the same rid_out on the host, from the host rid_in
        src = np.clip(lp.in_map, 0, max(rid_in_h.shape[0] - 1, 0))
        rid_out_h = np.where(lp.in_map >= 0, rid_in_h[src], -1).max(axis=1)
        if lp.final_mask.any():
            # keep a level's buffer only if some row finishes there
            fi = upload(np.flatnonzero(lp.final_mask), dev)
            bufs.append((rid_out[fi], col_c[fi], val_c[fi], counts[fi]))
        keep = ~lp.final_mask
        if not keep.any():
            if deciding:
                ss.finish.update(ladder_levels=li + 1, classes=None)
            break
        ki = upload(np.flatnonzero(keep), dev)
        rid_in, wcol, wval, wcnt = (rid_out[ki], col_c[ki], val_c[ki],
                                    counts[ki])
        rid_in_h = rid_out_h[keep]
        W_in = W_in * lp.F
        li += 1
    return nnz_row, bufs


def _plan_accum(a_hist: np.ndarray, a_psum: np.ndarray, budget: int):
    """Host layout of the accumulator region from the planning pack: span
    classes in the device sort order (descending), split greedily into
    parts whose padded accumulator slots fit ``budget`` (a lone row wider
    than the budget gets a part of its own). Returns (n_accum, total_p2,
    parts, abase): parts = [dict(row_lo, row_hi, slots, classes=[(R_pad,
    S, off, rid_of_out)])], abase each accumulator row's part-local slot
    base (local, so that it stays inside int32; the chunk pass drops the
    rows outside the active part)."""
    classes = [(k, int(a_hist[k]), 1 << k)
               for k in range(N_QCLASS - 1, -1, -1) if a_hist[k]]
    n_accum = int(a_hist.sum())
    total_p2 = int(a_psum.astype(np.int64).sum())
    if total_p2 >= 2 ** 31:
        raise ProductOverflow(
            f"accumulator region of {total_p2} products exceeds the 2^31 "
            "int32 ceiling; row-block the multiply")
    parts = []
    abase = np.zeros(max(n_accum, 1), np.int32)
    row = 0
    cur = None
    for _, rows, span in classes:
        done = 0
        while done < rows:
            if cur is None:
                cur = dict(row_lo=row, row_hi=row, slots=0, classes=[])
            avail = (budget - cur["slots"]) // span
            if avail < 1:
                if cur["classes"]:
                    parts.append(cur)
                    cur = None
                    continue
                avail = 1
            take = min(rows - done, avail)
            R_pad = _pow2(take)
            rid = np.full(R_pad, -1, np.int32)
            rid[:take] = np.arange(row, row + take)
            abase[row: row + take] = (cur["slots"]
                                      + np.arange(take, dtype=np.int64)
                                      * span).astype(np.int32)
            cur["classes"].append((R_pad, span, cur["slots"], rid))
            cur["slots"] += R_pad * span
            row += take
            done += take
            cur["row_hi"] = row
    if cur is not None and cur["classes"]:
        parts.append(cur)
    return n_accum, total_p2, parts, abase


def _run_accum(ss: StreamState, A: DeviceCSR, B: DeviceCSR, nnz_row,
               count: bool, new_values: bool = False):
    """Drive the accumulator region: per part, every chunk's products
    scatter-add into their rows' span windows (stream_chunk_accum), then
    each span class finalizes into staged compacted rows. ``new_values``
    gathers the record channel again (``_stream_operands``). Returns
    (nnz_row, staged buffers)."""
    ac = ss.accum
    if not ac or ss.rec2.n_chunks == 0:
        return nnz_row, []
    dev = ss.rows_sorted.device
    if nnz_row is None:
        nnz_row = torch.zeros(ss.rows_sorted.shape[0] + 1, dtype=I32,
                              device=dev)
        count = False
    rec = _stream_operands(A, B, ss.rec2, new_values)
    bufs = []
    for part in ac["parts"]:
        # float64 sums whatever the value type (one trailing slot takes
        # the dropped adds): a column of a hub row takes thousands of
        # atomic adds in no set order, and a float32 running sum of them
        # drifts past the oracle's tolerance on the bench's giant row
        acc = torch.zeros(part["slots"] + 1, dtype=torch.float64,
                          device=dev)
        pres = torch.zeros(part["slots"] + 1, dtype=I32, device=dev)
        for c in range(rec.n_chunks):
            acc, pres = stream_chunk_accum(rec, c, ss.abase, ss.cmin_s, acc,
                                           pres, part["row_lo"],
                                           part["row_hi"])
        acc = acc.to(c_value_dtype(A, B))
        for R_pad, S, off, rid in part["classes"]:
            nnz_row, buf = accum_finalize(
                ss.rows_sorted, acc[off: off + R_pad * S],
                pres[off: off + R_pad * S], ss.cmin_s, rid, nnz_row,
                R_c=R_pad, S_c=S, count=count)
            bufs.append(buf)
    return nnz_row, bufs


# ---------------------------------------------------------------------------
# Diagonal-plane routes: the gates and the plans (the reference's, with
# the same host decisions)
# ---------------------------------------------------------------------------


def _dia_band_spans(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR,
                    a_dmin: int, a_dmax: int, b_dmin: int, b_dmax: int):
    """The whole-matrix DIA gate's tests that need no product total:
    (span_a, span_b) when the spans fit the span cap, the int32 slots
    (span * rows + row, whatever the memory budget) and the memory
    budget, else None."""
    if not (a_dmin <= a_dmax and b_dmin <= b_dmax):
        return None
    m, n = A.shape[0], B.shape[1]
    sa = a_dmax - a_dmin + 1
    sb = b_dmax - b_dmin + 1
    sc_g = sa + sb - 1
    if (sa <= cfg.dia_span_cap and sb <= cfg.dia_span_cap
            and max(sa * m, sb * A.shape[1], sc_g * m) < 2 ** 31
            and plane_bytes(m, A.shape[1], n, sa, sb, A.data.dtype.itemsize)
            <= cfg.dia_mem_budget):
        return sa, sb
    return None


def _dia_waste_ok(cfg: SpgemmConfig, m: int, spans, sp_sat: int) -> bool:
    """The whole-matrix DIA gate's last test: the planes' work m * sa *
    sb within dia_waste_cap of the (saturated) product total."""
    sa, sb = spans
    return m * sa * sb <= cfg.dia_waste_cap * max(sp_sat, 1)


def _dia_spans(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR, a_dmin: int,
               a_dmax: int, b_dmin: int, b_dmax: int, sp_sat: int):
    """The whole-matrix DIA gate: (span_a, span_b) when the multiply runs
    over diagonal planes, else None."""
    spans = _dia_band_spans(cfg, A, B, a_dmin, a_dmax, b_dmin, b_dmax)
    if spans is None or not _dia_waste_ok(cfg, A.shape[0], spans, sp_sat):
        return None
    return spans


def _plan_dia(A: DeviceCSR, B: DeviceCSR, cfg: SpgemmConfig,
              timings: Optional[Timings], stats, dmin_a: int, dmin_b: int,
              sa: int, sb: int, track: bool) -> SpgemmPlan:
    """A contiguous-DIA plan: planes, convolution and staging in one
    counting pass, then ONE readback of the offsets' meta scalars."""
    m, n = A.shape[0], B.shape[1]
    k = A.shape[1]
    sc = sa + sb - 1
    _route("dia")
    with StageTimer(timings, "spGEMMCounting", track) as st:
        same = (B.indices is A.indices and B.data is A.data
                and B.shape == A.shape)
        slot_a = dia_slots(A.indptr, A.indices, dmin=dmin_a, span=sa, rows=m)
        slot_b = slot_a if same else dia_slots(
            B.indptr, B.indices, dmin=dmin_b, span=sb, rows=k)
        counts, present, cols_s, vals_s = dia_count_pipeline(
            slot_a, A.data, slot_b, B.data, sa=sa, sb=sb, m=m, k=k,
            dmin_a=dmin_a, sc=sc, n_cols=n, base_c=dmin_a + dmin_b,
            same=same)
        st.stop(counts)
    return _finish_dia(A, B, cfg, timings, stats, counts, present, cols_s,
                       vals_s, track, DiaState(
                           span_a=sa, span_b=sb, span_c=sc, dmin_a=dmin_a,
                           dmin_b=dmin_b, slot_a=slot_a, slot_b=slot_b,
                           present=present))


def _finish_dia(A, B, cfg, timings, stats, counts, present, cols_s, vals_s,
                track, state: DiaState) -> SpgemmPlan:
    """The offsets and the meta readback of either DIA flavour, and the
    emit decision: the uniform fast emit when the all-full interior run
    covers at least half of C (else the two edge gathers approach one
    full gather)."""
    m, sc = A.shape[0], state.span_c
    with StageTimer(timings, "allocC", track):
        row_offsets, meta = dia_offsets_meta(counts, sc=sc)
        # the ONE meta readback
        nnz, max_count, up, uq, u_ok, u_offs = (
            int(x) for x in readback(meta, "dia_meta"))
    if (cfg.dia_uniform_emit and u_ok and nnz > 0
            and (uq - up) * sc >= nnz // 2):
        state.uniform = (up, uq, u_offs)
    # staged planes: 2 int32-sized planes per (row, diagonal) slot
    if 2 * sc * m <= cfg.fused_staging_budget:
        state.staged = (cols_s, vals_s)
    return SpgemmPlan(A=A, B=B, cfg=cfg, row_offsets=row_offsets, nnz=nnz,
                      sum_products=stats.sum_products, max_count=max_count,
                      dia=state)


def _diag_bitmap_dev(indptr, indices, dmin: int, *, span: int):
    """Presence bitmap over diagonal offsets (col - row - dmin): one O(nnz)
    device pass (row ids by binary search, one scatter of ones)."""
    nnz = indices.shape[0]
    dev = indices.device
    bm = torch.zeros(span, dtype=I32, device=dev)
    if nnz:
        rid = row_ids(indptr, nnz)
        # a device-side one: a Python scalar here would be a host copy
        bm[torch.clamp(indices - rid - dmin, 0, span - 1)] = torch.ones(
            (), dtype=I32, device=dev)
    return bm


# past this span the device bitmap's fetch outweighs the host bincount
_DIAG_DEV_SPAN_MAX = 1 << 22


def _diag_offsets(dev, h, dmin: int, span: int) -> np.ndarray:
    """Distinct diagonal offsets (col - row) present in a matrix: the
    device bitmap (one O(nnz) pass and one (span,) readback) by default,
    since the host form's O(nnz) row-id decode took seconds at the
    stencil's 28.6M nonzeros in the reference; the host bincount past
    ``_DIAG_DEV_SPAN_MAX`` or without a device matrix."""
    if dev is not None and span <= _DIAG_DEV_SPAN_MAX:
        bm = _diag_bitmap_dev(dev.indptr, dev.indices, dmin, span=span)
        return np.flatnonzero(readback(bm, "diag_bitmap")) + dmin
    host_pass("diag_offsets")
    ip = np.asarray(h.row_offsets, np.int64)
    rid = np.repeat(np.arange(h.rows, dtype=np.int64), ip[1:] - ip[:-1])
    d = np.asarray(h.col_ids, np.int64) - rid
    return np.flatnonzero(np.bincount(d - dmin, minlength=span)) + dmin


def _sdia_gate(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR, ah, bh, hg):
    """Sparse-DIA eligibility (needs the attached HostCSR copies): the
    present-offset lists within the pair cap, the band within
    sdia_span_cap, the planes within dia_mem_budget, and last (the one
    test that reads ``hg.sum_products``) the work m * nd_a * nd_b within
    dia_waste_cap of the true product count. Returns (off_a, off_b,
    span_a, span_b) or None."""
    if not cfg.enable_sdia or ah is None or bh is None:
        return None
    if not (hg.a_dmin <= hg.a_dmax and hg.b_dmin <= hg.b_dmax):
        return None
    m = A.shape[0]
    k = A.shape[1]
    span_a = hg.a_dmax - hg.a_dmin + 1
    span_b = hg.b_dmax - hg.b_dmin + 1
    if span_a > cfg.sdia_span_cap or span_b > cfg.sdia_span_cap:
        return None
    # nd_a >= nnz / m, so past this the pair cap cannot hold: skip the scans
    if ah.nnz * bh.nnz > cfg.sdia_pair_cap * m * bh.rows:
        return None
    off_a = _diag_offsets(A, ah, hg.a_dmin, span_a)
    off_b = off_a if bh is ah else _diag_offsets(B, bh, hg.b_dmin, span_b)
    nd_a, nd_b = len(off_a), len(off_b)
    if nd_a * nd_b > cfg.sdia_pair_cap:
        return None
    nd_c = len(np.unique(off_a[:, None] + off_b[None, :]))
    if max(nd_a * m, nd_b * k, nd_c * m) >= 2 ** 31:
        return None
    pad_l, pad_r = sdia_pad(tuple(int(x) for x in off_a), m, k)
    if sdia_plane_bytes(m, k, nd_a, nd_b, nd_c, k + pad_l + pad_r,
                        A.data.dtype.itemsize) > cfg.dia_mem_budget:
        return None
    if m * nd_a * nd_b > cfg.dia_waste_cap * max(hg.sum_products, 1.0):
        return None
    return off_a, off_b, span_a, span_b


def _plan_sdia(A: DeviceCSR, B: DeviceCSR, cfg: SpgemmConfig,
               timings: Optional[Timings], stats, off_a, off_b, span_a: int,
               span_b: int, *, track: bool) -> SpgemmPlan:
    """A sparse-DIA plan: planes indexed by the present-offset lists,
    counting and staging in one pass, ONE meta readback."""
    m, n = A.shape[0], B.shape[1]
    k = A.shape[1]
    dev = A.device
    ta = tuple(int(x) for x in off_a)
    tb = tuple(int(x) for x in off_b)
    off_c = np.unique(np.asarray(off_a)[:, None] + np.asarray(off_b)[None, :])
    tc = tuple(int(x) for x in off_c)
    nd_a, nd_b, nd_c = len(ta), len(tb), len(tc)
    dmin_a, dmin_b = stats.a_dmin, stats.b_dmin
    _route("sdia")
    with StageTimer(timings, "spGEMMCounting", track) as st:
        lut_a = upload(sdia_lut(off_a, dmin_a, span_a), dev)
        slot_a = sdia_slots(A.indptr, A.indices, lut_a, dmin=dmin_a, rows=m)
        av, ah_p = dia_planes(slot_a, A.data, span=nd_a, rows=m)
        if (B.indices is A.indices and B.data is A.data
                and B.shape == A.shape):
            slot_b = slot_a
            bv, bh_p = av, ah_p
        else:
            lut_b = upload(sdia_lut(off_b, dmin_b, span_b), dev)
            slot_b = sdia_slots(B.indptr, B.indices, lut_b, dmin=dmin_b,
                                rows=k)
            bv, bh_p = dia_planes(slot_b, B.data, span=nd_b, rows=k)
        c_val, c_cnt = sdia_conv(av, ah_p, bv, bh_p, off_a=ta, off_b=tb,
                                 off_c=tc, m=m, k=k, with_hit=True)
        del av, ah_p, bv, bh_p
        doffs = upload(off_c.astype(np.int32), dev)
        counts, present, cols_s, vals_s = dia_count_stage(
            c_val, c_cnt, doffs, sc=nd_c, m=m, n_cols=n, base_c=0)
        st.stop(counts)
    return _finish_dia(A, B, cfg, timings, stats, counts, present, cols_s,
                       vals_s, track, DiaState(
                           span_a=nd_a, span_b=nd_b, span_c=nd_c,
                           dmin_a=dmin_a, dmin_b=dmin_b, slot_a=slot_a,
                           slot_b=slot_b, present=present, off_a=ta,
                           off_b=tb, doffs=doffs))


def _host_dia_rows_plausible(ah, bh, cfg: SpgemmConfig,
                             ends: HostEnds) -> bool:
    """Host twin of the per-row DIA split's robust-band gate (5% outlier
    allowance per side of the per-row diagonal extents), O(rows) from the
    call's row ends ``ends``."""

    def robust(h):
        e = ends(h)
        n_ne = e.dfirst.size
        if n_ne == 0:
            return 0, -1
        pad = n_ne // 20
        return (int(np.sort(e.dfirst)[pad]),
                int(np.sort(e.dlast)[n_ne - 1 - pad]))

    dlo_a, dhi_a = robust(ah)
    dlo_b, dhi_b = (dlo_a, dhi_a) if bh is ah else robust(bh)
    return bool(dhi_a >= dlo_a and dhi_b >= dlo_b
                and dhi_a - dlo_a + 1 <= cfg.dia_span_cap
                and dhi_b - dlo_b + 1 <= cfg.dia_span_cap)


def _host_dense_plausible(ah, tile_rows: int, kw_max: int, ends: HostEnds,
                          bh=None, cw_max: int = 0) -> bool:
    """Host pre-reject of the dense-tile route: some row tile must have
    its A column range within the k-window and (with ``bh``) its output
    column range within the c-window. A's windows are O(rows) from the
    call's row ends ``ends``; the output window reads every nonzero of A
    (an O(nnz) pass, ``dense_b_window``)."""
    m = int(ah.rows)
    ci = np.asarray(ah.col_ids)
    if m == 0 or ci.size == 0:
        return False
    INTM = np.iinfo(np.int64).max
    t0 = np.arange(0, m, tile_rows)

    def tiles(first, last):
        return (np.minimum.reduceat(first, t0),
                np.maximum.reduceat(last, t0))

    def cols(h):
        """Each row's first and last column id, INTM and -1 if empty."""
        e = ends(h)
        if e.dfirst.size == e.ne.size:
            return e.first, e.last
        return np.where(e.ne, e.first, INTM), np.where(e.ne, e.last, -1)

    ne = ends(ah).ne
    tmin, tmax = tiles(*cols(ah))
    ok = (tmax >= 0) & (tmax - tmin + 1 <= kw_max)
    if not ok.any():
        return False
    if bh is None or cw_max <= 0:
        return True
    if np.asarray(bh.col_ids).size == 0:
        return False
    host_pass("dense_b_window")
    bfirst, blast = cols(bh)
    starts = np.minimum(np.asarray(ah.row_offsets, np.int64)[:-1],
                        ci.size - 1)
    rmin = np.minimum.reduceat(bfirst[ci], starts)
    rmax = np.maximum.reduceat(blast[ci], starts)
    cmin_t, cmax_t = tiles(np.where(ne, rmin, INTM), np.where(ne, rmax, -1))
    return bool((ok & (cmax_t >= 0)
                 & (cmax_t - cmin_t + 1 <= cw_max)).any())


def _check_limits(cfg: SpgemmConfig, sp_sat: int, mxrow_sat: int):
    """int32 stream-position ceiling (ProductOverflow past it)."""
    if mxrow_sat >= 1 << 30:
        raise ProductOverflow(
            f"a single row has ~{mxrow_sat} intermediate products, near "
            "the int32 per-row ceiling")
    if sp_sat >= cfg.block_products:
        raise ProductOverflow(
            f"~{sp_sat:.3g} intermediate products exceed one plan's budget "
            f"({cfg.block_products})")


def lite_band_ok(cfg: SpgemmConfig, ext, ah, bh, m: int):
    """The lite host gate's band test from the band extremes ``ext``:
    (the contiguous DIA route possible, the sparse DIA route possible)."""
    a0, a1, b0, b1 = ext
    sa_l, sb_l = a1 - a0 + 1, b1 - b0 + 1
    contig_ok = bool(a0 <= a1 and b0 <= b1 and sa_l <= cfg.dia_span_cap
                     and sb_l <= cfg.dia_span_cap)
    sdia_ok = bool(cfg.enable_sdia and a0 <= a1 and b0 <= b1
                   and sa_l <= cfg.sdia_span_cap
                   and sb_l <= cfg.sdia_span_cap
                   and ah.nnz * bh.nnz <= cfg.sdia_pair_cap * m * bh.rows)
    return contig_ok, sdia_ok


def _gate_readback(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR, stats,
                   m: int):
    """The early routing gate: the 7 gate scalars in one small readback
    before the planning pass. Returns (dmin_a, dmin_b, span_a, span_b)
    when the DIA gate passes, else runs the overflow guards and returns
    None."""
    gate = plan_gate(A.indptr, A.indices, B.indptr, B.indices,
                     stats.row_ops, stats.row_ops_f, m=m)
    (a_dmin, a_dmax, b_dmin, b_dmax, sp_sat, mxrow_sat,
     _sp_exact) = (int(x) for x in readback(gate, "gate"))
    spans = _dia_spans(cfg, A, B, a_dmin, a_dmax, b_dmin, b_dmax, sp_sat)
    if spans is not None:
        return (a_dmin, b_dmin) + spans
    _check_limits(cfg, sp_sat, mxrow_sat)
    return None


@dataclasses.dataclass(frozen=True)
class PlanPack:
    """The planning pack of ``stream.plan_device_stream``, read on the
    host: the class histograms, the dense-tile scalars (n_eligible, kw,
    cw, la, lb), the 7 gate scalars, the per-row DIA band and routed row
    count, the live A slots of the stream and the accumulator, and the
    tight layout's W, total_q, n_wide, r_wide and wide segments."""

    s_hist: np.ndarray
    d_hist: np.ndarray
    a_hist: np.ndarray
    a_psum: np.ndarray
    dense: tuple
    gate: tuple
    dia_band: tuple
    n_live: int
    n_live2: int
    W: int
    total_q: int
    n_wide: int
    r_wide: int
    wide_segs: np.ndarray   # the pack's window of N_WSEG_PACK segments


def read_pack(pack_h: np.ndarray) -> PlanPack:
    q = N_QCLASS

    def ints(lo, hi):
        return tuple(int(x) for x in pack_h[lo: hi])

    tight = pack_h[4 * q + 19:]
    W, total_q, n_wide, r_wide = (int(x) for x in tight[:4])
    return PlanPack(
        s_hist=pack_h[:q], d_hist=pack_h[q: 2 * q],
        a_hist=pack_h[2 * q: 3 * q], a_psum=pack_h[3 * q: 4 * q],
        dense=ints(4 * q, 4 * q + 5), gate=ints(4 * q + 5, 4 * q + 12),
        dia_band=ints(4 * q + 12, 4 * q + 17),
        n_live=int(pack_h[4 * q + 17]), n_live2=int(pack_h[4 * q + 18]),
        W=W, total_q=total_q, n_wide=n_wide, r_wide=r_wide,
        wide_segs=tight[4:])


def stream_records(A: DeviceCSR, B: DeviceCSR, a32, rows_sorted, e, q_sorted,
                   layout: StreamLayout, n_live: int):
    """The stream's A-slot records (``build_srec``: p0, su, sa, src, pend)
    for the ``n_live`` live slots, compacted unless one chunk's window
    sees every record, and each chunk's first record (sid_bases); a plan
    with no stream products gets one-element placeholders."""
    dev = A.device
    if layout.total_q == 0:
        zero = torch.zeros(1, dtype=I32, device=dev)
        return (zero,) * 6
    CP = layout.G * layout.W
    nl = _pow2(max(n_live, 1))
    p0, su, sa, src, pend = build_srec(
        A.indptr, A.indices, a32, B.indptr[:-1], B.indptr[1:] - B.indptr[:-1],
        rows_sorted, e, q_sorted, m=A.shape[0], nl=nl,
        compact=min(nl, A.nnz) > CP + 2)
    cks = torch.arange(max(layout.n_chunks, 1), dtype=I32, device=dev) * CP
    return p0, su, sa, src, pend, torch.searchsorted(p0, cks, out_int32=True)


def host_layout(pk: PlanPack, cfg: SpgemmConfig, ops_sorted):
    """The host half of planning from the pack: the stream layout, the
    wide rows' merge levels and the accumulator's parts (``_plan_accum``).
    Past the pack's window of wide segments, ONE extra fetch of the wide
    rows' ops. Returns (layout, lplans, _plan_accum's tuple)."""
    n_accum_h = int(pk.a_hist.sum())
    if pk.n_wide <= N_WSEG_PACK:
        wide_segs = pk.wide_segs[: pk.n_wide].astype(np.int64)
    else:
        wide_ops = readback(ops_sorted[n_accum_h: n_accum_h + pk.n_wide],
                            "wide_ops").astype(np.int64)
        wide_segs = -(-wide_ops // pk.W)
    layout = plan_layout(pk.s_hist, pk.d_hist, pk.W, cfg.product_budget,
                         total_q=pk.total_q, n_wide=pk.n_wide,
                         r_wide=pk.r_wide, wide_segs=wide_segs)
    lplans = plan_levels(layout, F=cfg.stream_level_factor,
                         max_width=cfg.stream_max_width)
    # the accumulator region sorts first: every layout-derived row offset
    # (wide rids, direct class starts) shifts by n_accum
    return layout, lplans, _plan_accum(pk.a_hist, pk.a_psum,
                                       cfg.accum_budget)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _route(name: str) -> None:
    """Count a plan's route in ``ROUTES`` and mark it by the zero-length
    range ``speck.route.<name>``."""
    ROUTES[name] = ROUTES.get(name, 0) + 1
    with span("speck.route." + name):
        pass


def dia_route_possible(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR) -> bool:
    return bool(cfg.enable_dia and A.canonical and B.canonical
                and A.nnz > 0 and B.nnz > 0)


def _ranged(prefix: str):
    """The default ``step`` of ``lite_gate`` and ``host_gates``: each
    planning step run as it is, inside the range ``<prefix>.<step>`` (a
    probe passes a ``step`` that times each step by its name)."""

    def call(name: str, fn):
        with span(f"{prefix}.{name}"):
            return fn()

    return call


def lite_gate(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR, ah, bh,
              ends: HostEnds, step=_ranged("speck.plan.lite_gate")):
    """The lite host gate of an input past ``host_analysis_max_nnz`` (A's
    and B's host copies ``ah``, ``bh``; their row ends from the call's
    ``ends``): (lite, route, gate), where route is "dia" with the spans
    as gate, "sdia" with ``_sdia_gate``'s output, or None (the band
    admits no diagonal route). The product total is computed only where a
    test reads it."""
    ext = step("host_band_extremes",
               lambda: host_band_extremes(ah, bh, ends))
    if not any(lite_band_ok(cfg, ext, ah, bh, A.shape[0])):
        return None, None, None
    lite = step("host_gate_lite", lambda: host_gate_lite(ah, bh, ext))

    def dia_spans():
        # the waste test, the one that reads the total, goes last
        spans = _dia_band_spans(cfg, A, B, *ext)
        if spans is None or not _dia_waste_ok(cfg, A.shape[0], spans,
                                              lite.sp_sat):
            return None
        return spans

    spans = step("_dia_spans", dia_spans)
    if spans is not None:
        return lite, "dia", spans
    sd = step("_sdia_gate", lambda: _sdia_gate(cfg, A, B, ah, bh, lite))
    return lite, (None if sd is None else "sdia"), sd


def host_gates(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR, ah, bh,
               dia_possible: bool, ends: HostEnds,
               step=_ranged("speck.plan.host_gates")):
    """The planning pass's route gates: (use_dense, use_dia_rows), each
    confirmed by its host plausibility test where A's host copy ``ah`` is
    at hand (B's ``bh`` is read by the dense test's output window only up
    to ``host_analysis_max_nnz``); the row ends from the call's ``ends``,
    shared by the two tests."""
    use_dense = bool(cfg.enable_dense and A.canonical and B.canonical
                     and B.nnz > 0)
    if use_dense and ah is not None:
        use_dense = step("_host_dense_plausible", lambda: (
            _host_dense_plausible(
                ah, cfg.dense_tile_rows, cfg.dense_kw, ends,
                bh=bh if A.nnz <= cfg.host_analysis_max_nnz else None,
                cw_max=cfg.dense_cw)))
    use_dia_rows = bool(cfg.dia_rows and dia_possible)
    if use_dia_rows and ah is not None:
        use_dia_rows = step("_host_dia_rows_plausible",
                            lambda: _host_dia_rows_plausible(ah, bh, cfg,
                                                             ends))
        # a host-confirmed split claims the banded bulk and leaves no
        # tile dense-eligible
        use_dense = use_dense and not use_dia_rows
    return use_dense, use_dia_rows


def _max_tiles(cfg: SpgemmConfig) -> int:
    return max(0, cfg.fused_staging_budget
               // (cfg.dense_tile_rows * cfg.dense_cw))


def record_bits(A: DeviceCSR) -> torch.Tensor:
    """A's value bits on the stream's record channel: float32 values as
    int32 words, else zeros (float64 has no value bits there: the A-source
    map rides it instead, from build_srec's src)."""
    return (A.data.contiguous().view(I32) if packable(A.data)
            else torch.zeros_like(A.indices))


def plan_stream(A: DeviceCSR, B: DeviceCSR, cfg: SpgemmConfig, stats, *,
                use_dense: bool, use_dia_rows: bool):
    """``stream.plan_device_stream`` with the planning pass's arguments,
    the route gates' decisions given (``host_gates``)."""
    max_tiles = _max_tiles(cfg)
    return plan_device_stream(
        A.indptr, A.indices, record_bits(A), B.indptr, B.indices,
        stats.row_ops, stats.row_ops_f, stats.a_len, min_q=cfg.stream_min_q,
        direct_ok=bool(B.canonical) and cfg.enable_direct, m=A.shape[0],
        w0=cfg.stream_width, w_cap=cfg.stream_width_cap,
        use_dia_rows=use_dia_rows, dia_span_cap=cfg.dia_span_cap,
        dia_waste_cap=cfg.dia_waste_cap, dia_mem_budget=cfg.dia_mem_budget,
        dia_itemsize=A.data.dtype.itemsize,
        use_dense=use_dense and max_tiles > 0, tile_rows=cfg.dense_tile_rows,
        kw_max=cfg.dense_kw, cw_max=cfg.dense_cw, la_max=cfg.dense_la,
        lb_max=cfg.dense_lb, max_tiles=max_tiles,
        use_accum=bool(cfg.enable_accum and B.canonical),
        accum_min_ops=cfg.accum_min_ops, accum_span_cap=cfg.accum_span_cap)


def plan_spgemm(A: DeviceCSR, B: DeviceCSR,
                cfg: Optional[SpgemmConfig] = None,
                timings: Optional[Timings] = None) -> SpgemmPlan:
    """Analysis + planning + symbolic counting: everything up to and
    including C's row offsets."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"dimension mismatch: A is {A.shape}, B is {B.shape}")
    cfg = cfg or SpgemmConfig()
    check_supported(cfg, A, B)
    m, n = A.shape[0], B.shape[1]
    dev = A.device
    track = timings is not None and timings.measure_all

    if m == 0 or A.nnz == 0:
        _route("empty")
        return SpgemmPlan(A=A, B=B, cfg=cfg,
                          row_offsets=torch.zeros(m + 1, dtype=I32,
                                                  device=dev),
                          nnz=0, sum_products=0.0)

    hg = None
    ah = bh = None
    if cfg.host_analysis:
        ah, bh = host_of(A), host_of(B)
        if ah is None or (bh is None and B is not A):
            ah = bh = None
    bh_eff = ah if (B is A or bh is ah) else bh
    # each host copy's row ends, built by the first step that reads them
    ends = HostEnds()
    if ah is not None and A.nnz <= cfg.host_analysis_max_nnz:
        with StageTimer(timings, "countProducts", track), \
                span("speck.plan.host_analyze"):
            hg = host_analyze(ah, bh_eff, ends)
    dia_possible = dia_route_possible(cfg, A, B)
    band_plausible = bool(
        A.nnz <= m * cfg.dia_span_cap
        and B.nnz <= max(B.shape[0], 1) * cfg.dia_span_cap)
    gate_done = False
    dia_lite_rejected = False
    if hg is None and ah is not None and dia_possible:
        # lite host gate for inputs past host_analysis_max_nnz
        with StageTimer(timings, "loadBalanceCounting", track):
            lite, route, gate = lite_gate(cfg, A, B, ah, bh_eff, ends)
            if route == "dia":
                return _plan_dia(A, B, cfg, timings, lite, lite.a_dmin,
                                 lite.b_dmin, *gate, track)
            if route == "sdia":
                return _plan_sdia(A, B, cfg, timings, lite, *gate,
                                  track=track)
            dia_lite_rejected = True
    if hg is None:
        with StageTimer(timings, "countProducts", track) as st:
            stats = analyze(A, B)
            st.stop(stats.row_ops)
    if hg is not None:
        with StageTimer(timings, "loadBalanceCounting", track):
            if dia_possible:
                spans = _dia_spans(cfg, A, B, hg.a_dmin, hg.a_dmax,
                                   hg.b_dmin, hg.b_dmax, hg.sp_sat)
                if spans is not None:
                    return _plan_dia(A, B, cfg, timings, hg, hg.a_dmin,
                                     hg.b_dmin, *spans, track)
                sd = _sdia_gate(cfg, A, B, ah, bh_eff, hg)
                if sd is not None:
                    return _plan_sdia(A, B, cfg, timings, hg, *sd,
                                      track=track)
            _check_limits(cfg, hg.sp_sat, hg.mxrow_sat)
            gate_done = True
            stats = hg.to_device(dev)
    elif (dia_possible and cfg.dia_gate_early and band_plausible
          and not dia_lite_rejected):
        # early routing gate: one small readback before the planning pass
        with StageTimer(timings, "loadBalanceCounting", track):
            gate_done = True
            spans = _gate_readback(cfg, A, B, stats, m)
            if spans is not None:
                return _plan_dia(A, B, cfg, timings, stats, *spans, track)

    with StageTimer(timings, "loadBalanceCounting", track):
        use_dense, use_dia_rows = host_gates(cfg, A, B, ah, bh_eff,
                                             dia_possible, ends)
        tr, max_tiles = cfg.dense_tile_rows, _max_tiles(cfg)
        a32 = record_bits(A)
        with span("speck.plan.device_plan"):
            (rows_sorted, e, q_sorted, el, ops_sorted, nnz_init, pack,
             dia_mask, t_r0, t_kb, t_cb, t_valid, e2, q2_sorted,
             cmin_sorted) = plan_stream(A, B, cfg, stats,
                                        use_dense=use_dense,
                                        use_dia_rows=use_dia_rows)
        # the ONE planning host sync
        pk = read_pack(readback(pack, "plan_pack"))
        n_elig, kw_e, cw_e, la_e, lb_e = pk.dense
        (a_dmin, a_dmax, b_dmin, b_dmax, sp_sat, mxrow_sat,
         sp_exact) = pk.gate
        dr_dlo_a, dr_dhi_a, dr_dlo_b, dr_dhi_b, n_dia = pk.dia_band
        n_live, n_live2, W = pk.n_live, pk.n_live2, pk.W
        if not gate_done:
            if dia_possible:
                spans = _dia_spans(cfg, A, B, a_dmin, a_dmax, b_dmin,
                                   b_dmax, sp_sat)
                if spans is not None:
                    return _plan_dia(A, B, cfg, timings, stats, a_dmin,
                                     b_dmin, *spans, track)
            _check_limits(cfg, sp_sat, mxrow_sat)
        with span("speck.plan.host_layout"):
            (layout, lplans, (n_accum, total_p2, accum_parts,
                              abase_h)) = host_layout(pk, cfg, ops_sorted)

        with span("speck.plan.groups"):
            groups: List[DirectGroup] = []
            max_chunk_rows = 1
            for cap, start, count in layout.direct_classes:
                start = start + n_accum
                full = max(1, 4 * cfg.product_budget // cap)
                rpc = _bucket_rows(count, full)
                max_chunk_rows = max(max_chunk_rows, rpc)
                n_ch = math.ceil(count / rpc)
                k = _pow2(n_ch)
                starts = np.zeros(k, np.int32)
                valids = np.zeros(k, np.int32)
                for c in range(n_ch):
                    starts[c] = start + c * rpc
                    valids[c] = min(rpc, count - c * rpc)
                groups.append(DirectGroup(cap=cap, rows=rpc, starts=starts,
                                          valids=valids))
            rows_padded = torch.cat(
                [rows_sorted, torch.zeros(max_chunk_rows, dtype=I32,
                                          device=dev)])

            dense_grp: Optional[DenseGroup] = None
            if n_elig > 0:
                db = max(1, cfg.dense_tiles_per_dispatch)
                n_full, tail = divmod(n_elig, db)
                k = n_full * db + (_pow2(tail) if tail else 0)
                boffs = [i * db for i in range(n_full + 1)]
                if tail:
                    boffs.append(k)
                if k > t_r0.shape[0]:
                    padn = k - t_r0.shape[0]

                    def padded(x, fill):
                        return torch.cat([x, torch.full(
                            (padn,), fill, dtype=I32, device=dev)])

                    t_r0, t_kb, t_cb, t_valid = (
                        padded(t_r0, m), padded(t_kb, 0), padded(t_cb, 0),
                        padded(t_valid, 0))

                def ceil128(v):
                    return max(128, -(-int(v) // 128) * 128)

                dense_grp = DenseGroup(
                    r0s=t_r0[:k], kbases=t_kb[:k], cbases=t_cb[:k],
                    valids=t_valid[:k], boffs=boffs, tile_rows=tr,
                    kw=ceil128(kw_e), cw=ceil128(cw_e),
                    la=_pow2(max(8, la_e)), lb=_pow2(max(8, lb_e)),
                    full_cover=(n_elig == -(-m // tr)))

        pack_bits = int(n + 1).bit_length()
        if (W // cfg.stream_min_q) * (1 << pack_bits) >= 2**31:
            # the packed key would overflow int32: the two-key chunk sort
            pack_bits = 0
        G = layout.G
        with span("speck.plan.records"):
            p0, su, sa, src, pend, sid_bases = stream_records(
                A, B, a32, rows_sorted, e, q_sorted, layout, n_live)
        # fused staging: 3 int32 planes per stream slot and the dense tiles
        staging = 3 * layout.total_q + (dense_grp.staging_slots
                                        if dense_grp else 0)
        fused = staging <= cfg.fused_staging_budget
        wide_rid_h = n_accum + np.repeat(
            np.arange(layout.n_wide, dtype=np.int32), layout.wide_segs)
        ss = StreamState(
            layout=layout, lplans=lplans, rows_sorted=rows_sorted,
            rows_padded=rows_padded, e=e, q_sorted=q_sorted, el=el,
            ops_sorted=ops_sorted,
            rec=ChunkRecords(e, p0, su, sa, src, pend, None, sid_bases, G=G,
                             g_last=layout.g_last, W=W,
                             n_chunks=layout.n_chunks, n_cols=n,
                             pack_bits=pack_bits),
            fused=fused, products=stream_products(
                pk, hg, bool(B.canonical) and cfg.enable_direct),
            wide_rid_in=upload(wide_rid_h, dev), wide_rid_in_h=wide_rid_h,
            dense_elig=n_elig if use_dense and max_tiles > 0 else None,
            n_accum=n_accum)
        if n_accum and total_p2:
            # the accumulator's chunks take the stream's full budget (a
            # short stream would otherwise cut them to its own size)
            G2 = max(G, cfg.product_budget // W)
            n_chunks2 = -(-total_p2 // (G2 * W))
            with span("speck.plan.records"):
                p02, su2, sa2, src2, pend2 = build_srec(
                    A.indptr, A.indices, a32, B.indptr[:-1],
                    B.indptr[1:] - B.indptr[:-1], rows_sorted, e2,
                    q2_sorted, m=m, nl=_pow2(max(n_live2, 1)))
            cks = torch.arange(n_chunks2, dtype=I32, device=dev) * (G2 * W)
            ss.rec2 = ChunkRecords(
                e2, p02, su2, sa2, src2, pend2, None,
                torch.searchsorted(p02, cks, out_int32=True), G=G2,
                g_last=G2, W=W, n_chunks=n_chunks2, n_cols=n,
                pack_bits=pack_bits)
            ss.cmin_s = cmin_sorted
            ss.abase = upload(abase_h, dev)
            for part in accum_parts:
                part["classes"] = [(R_pad, S, off, upload(rid, dev))
                                   for R_pad, S, off, rid in part["classes"]]
            ss.accum = dict(parts=accum_parts)

        # the per-row DIA split's group (its device gate passed: n_dia > 0)
        dia_grp: Optional[DiaRowGroup] = None
        if n_dia > 0:
            dr_sa = dr_dhi_a - dr_dlo_a + 1
            dr_sb = dr_dhi_b - dr_dlo_b + 1
            slot_a = dia_slots(A.indptr, A.indices, dia_mask, dmin=dr_dlo_a,
                               span=dr_sa, rows=m, masked=True)
            b_in = dia_row_inband(B.indptr, B.indices, dmin=dr_dlo_b,
                                  dmax=dr_dhi_b)
            slot_b = dia_slots(B.indptr, B.indices, b_in, dmin=dr_dlo_b,
                               span=dr_sb, rows=B.shape[0], masked=True)
            dia_grp = DiaRowGroup(
                span_a=dr_sa, span_b=dr_sb, span_c=dr_sa + dr_sb - 1,
                dmin_a=dr_dlo_a, dmin_b=dr_dlo_b, slot_a=slot_a,
                slot_b=slot_b,
                present=torch.zeros((0, 0), dtype=torch.bool, device=dev))

    with StageTimer(timings, "spGEMMCounting", track) as st:
        # one trailing drop slot (see ops/stream.py)
        nnz_row = torch.cat([nnz_init.to(I32),
                             torch.zeros(1, dtype=I32, device=dev)])
        raw_chunks: List[int] = []
        if dia_grp is not None:
            dg = dia_grp
            c_val, c_cnt = dia_rows_conv_fused(
                dg.slot_a, A.data, dg.slot_b, B.data, sa=dg.span_a,
                sb=dg.span_b, m=m, k=A.shape[1], dmin_a=dg.dmin_a,
                with_hit=True)
            dg.present = c_cnt.t() > 0.5   # exact: fp32 sums of 1.0
            dg.cvT = c_val.t()
            nnz_row[:m] += torch.sum(dg.present, dim=1, dtype=I32)
        dense_staged: Optional[List[tuple]] = None
        if dense_grp is not None:
            apk, bpk = _dense_operands(A, B)
            dense_staged = []
            for r0s, kbs, cbs, _ in dense_grp.batches():
                with span("speck.dense.batch"):
                    nnz_row, st_b = dense_tiles(
                        r0s, kbs, cbs, A.indptr, A.indices, A.data,
                        B.indptr, B.indices, B.data, nnz_row, apk, bpk,
                        tile_rows=dense_grp.tile_rows, kw=dense_grp.kw,
                        cw=dense_grp.cw, la=dense_grp.la, lb=dense_grp.lb,
                        m=m, k_dim=A.shape[1], n_cols=n,
                        densify=cfg.dense_densify)
                dense_staged.append(st_b)
        if layout.n_chunks > 0 and layout.total_q > 0:
            rec = _stream_operands(A, B, ss.rec)
            staged = []
            for c in range(layout.n_chunks):
                if fused and c * G >= layout.r_wide:
                    raw_chunks.append(c)
                with span("speck.count.chunk"):
                    nnz_row, stg = count_chunk(ss, rec, nnz_row, c,
                                               cfg.stream_compact_impl)
                staged.append(stg)
            nw_chunks = -(-layout.r_wide // G) if layout.r_wide else 0
            nnz_row, level_bufs = _run_wide(
                ss, staged[:nw_chunks], nnz_row, n, count=True,
                max_width=cfg.stream_max_width,
                compact_impl=cfg.stream_compact_impl)
            ss.staged = staged if fused else None
            ss.level_bufs = level_bufs
        if ss.accum:
            with span("speck.accum"):
                nnz_row, ss.accum_bufs = _run_accum(ss, A, B, nnz_row,
                                                    count=True)
        st.stop(nnz_row)

    with StageTimer(timings, "allocC", track):
        row_offsets, meta = _offsets_from_counts(nnz_row[:m])
        # the ONE readback of nnz(C) and the widest row (it trims the
        # dense emit)
        nnz, max_count = (int(x) for x in readback(meta, "nnz_meta"))
        # no-duplicate fast path: nnz(C) == products means every live raw
        # slot is a run-last, so raw chunks already equal their compaction
        if ss.staged is not None and raw_chunks and nnz != sp_exact:
            with span("speck.alloc.compact"):
                for c in raw_chunks:
                    rid_r, col_r, val_r, counts_r = ss.staged[c]
                    ss.staged[c] = compact_staged(
                        rid_r, col_r, val_r, counts_r, n_cols=n,
                        compact_impl=cfg.stream_compact_impl)

    _route("dense" if dense_grp is not None and dense_grp.full_cover
           and layout.n_stream_rows == 0 and not groups else "stream")
    return SpgemmPlan(A=A, B=B, cfg=cfg, row_offsets=row_offsets, nnz=nnz,
                      sum_products=stats.sum_products, stream=ss,
                      groups=groups, dense=dense_grp,
                      dense_staged=dense_staged, max_count=max_count,
                      dia_rows=dia_grp)


def spgemm(A: DeviceCSR, B: DeviceCSR, cfg: Optional[SpgemmConfig] = None,
           timings: Optional[Timings] = None) -> DeviceCSR:
    """C = A @ B on A's device: exact two-phase SpGEMM with sorted rows."""
    track_complete = timings is not None and timings.measure_complete
    t0 = time.perf_counter()
    try:
        plan = plan_spgemm(A, B, cfg, timings)
        C = plan.execute(timings=timings)
    except ProductOverflow:
        C = _spgemm_blocked(A, B, cfg or SpgemmConfig(), timings)
    if track_complete:
        sync_tensors(C.data)
        timings.add("complete", (time.perf_counter() - t0) * 1e3)
    return C


def _spgemm_blocked(A: DeviceCSR, B: DeviceCSR, cfg: SpgemmConfig,
                    timings: Optional[Timings] = None) -> DeviceCSR:
    """C = A @ B as a sequence of row-block multiplies when the product
    total exceeds one plan's budget (``block_products``).

    Rows split greedily so that each block carries at most
    ``block_products // 2`` products (half the trigger, so a block never
    triggers again); each block plans and executes as usual, and the
    blocks' results concatenate into one CSR. The split costs two host
    fetches: the per-row products (exact from the host analysis when the
    HostCSR copies are attached, else the device analysis's float twin)
    and A's row offsets. A single row above the per-block budget raises
    ProductOverflow."""
    m, n = A.shape[0], B.shape[1]
    dev = A.device
    budget = max(1, cfg.block_products // 2)
    _route("blocked")
    ah, bh = host_of(A), host_of(B)
    if (cfg.host_analysis and A.nnz <= cfg.host_analysis_max_nnz
            and ah is not None and (bh is not None or B is A)):
        row_ops = np.asarray(host_analyze(
            ah, ah if (B is A or bh is ah) else bh, HostEnds()).row_ops,
            np.int64)
    else:
        row_ops = np.maximum(readback(
            analyze(A, B).row_ops_f, "block_row_ops").astype(np.float64),
            0.0).astype(np.int64)
    widest = int(row_ops.max(initial=0))
    if widest > budget:
        raise ProductOverflow(
            f"a single row has {widest} products, above the per-block "
            f"budget ({budget}); raise BlockProducts")
    indptr_h = readback(A.indptr, "block_indptr").astype(np.int64)
    cum = np.cumsum(row_ops)
    blocks = []
    r0 = 0
    while r0 < m:
        base = int(cum[r0 - 1]) if r0 else 0
        r1 = int(np.searchsorted(cum, base + budget, side="right"))
        r1 = min(m, max(r1, r0 + 1))
        blocks.append((r0, r1))
        r0 = r1
    ip_parts, c_parts, v_parts = [], [], []
    off = 0
    for r0, r1 in blocks:
        s, t = int(indptr_h[r0]), int(indptr_h[r1])
        A_blk = DeviceCSR(indptr=A.indptr[r0: r1 + 1] - s,
                          indices=A.indices[s:t], data=A.data[s:t],
                          shape=(r1 - r0, A.shape[1]), nnz=t - s,
                          canonical=A.canonical)
        Cb = plan_spgemm(A_blk, B, cfg, timings).execute(timings=timings)
        if off + Cb.nnz >= 2 ** 31:
            raise ProductOverflow(
                f"nnz(C) exceeds the int32 output ceiling at row {r1}")
        ip_parts.append(Cb.indptr[:-1] + off)
        c_parts.append(Cb.indices[: Cb.nnz])
        v_parts.append(Cb.data[: Cb.nnz])
        off += Cb.nnz
    ip_parts.append(torch.full((1,), off, dtype=I32, device=dev))
    return DeviceCSR(
        indptr=torch.cat(ip_parts),
        indices=(torch.cat(c_parts) if c_parts
                 else torch.zeros(0, dtype=I32, device=dev)),
        data=(torch.cat(v_parts) if v_parts
              else torch.zeros(0, dtype=c_value_dtype(A, B), device=dev)),
        shape=(m, n), nnz=off, canonical=True)
