"""What the stage probes share: the row of a stage and its line, the
probe's device, and the counting calls of a plan: a chunk as
``ops.spgemm.plan_spgemm``'s counting loop runs it (``count_chunk``, on
``_stream_operands``), and its expand and sort stages with the arguments
``stream_chunk`` gives them, so that a probe times the calls the plan
makes. The planning calls are ``ops.spgemm``'s own (``lite_gate``,
``host_gates``, ``plan_stream``, ``host_layout``, ``stream_records``).

A row is (label, median ms, min ms, outputs): the host clock around the
stage (``timing.host_ms``: one warm call, then the repetitions, each
ending in a synchronize on a card), and the last call's outputs.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..ops.spgemm import _knobs, _stream_operands, count_chunk
from ..ops.stream import _expand_chunk, _sort_rect
from ..utils.device import resolve_device
from .timing import card, host_ms

Row = Tuple[str, float, float, Any]
I32 = torch.int32


def timed(label: str, fn, reps: int) -> Row:
    med, mn, out = host_ms(fn, reps)
    return label, med, mn, out


def start(device=None):
    """The probe's device, resolved before any matrix is made (so that
    without a card the default raises first), and the text that stands
    beside each of its numbers: the card's name and power limit."""
    dev = resolve_device(device)
    return dev, (card() if dev.type == "cuda" else "cpu, not a card")


def print_rows(rows, where: str) -> None:
    for label, med, mn, _ in rows:
        print(f"# {label}: median {med:.3f} ms, min {mn:.3f} ms [{where}]",
              flush=True)


def layout_line(plan) -> str:
    """The stream layout and routes of a plan, as the scripts print them."""
    ss = plan.stream
    if ss is None:
        return (f"layout: no stream (dia={plan.dia is not None}, "
                f"dense={plan.dense is not None})")
    lo = ss.layout
    fin = ss.finish or {}
    return (f"layout: W={lo.W} G={lo.G} n_chunks={lo.n_chunks} "
            f"total_q={lo.total_q} n_wide={lo.n_wide} r_wide={lo.r_wide} "
            f"stream_rows={lo.n_stream_rows} direct={lo.n_direct_rows} "
            f"dense={plan.dense is not None} "
            f"diarows={plan.dia_rows is not None} fused={ss.fused} "
            f"pack_bits={ss.pack_bits} finish classes="
            f"{[(f['R2'], f['W2']) for f in fin.get('classes') or []]}")


def chunk_operands(plan):
    """The expand's record channel and B operand, as the counting loop
    takes them."""
    ss = plan.stream
    return _stream_operands(plan.A, plan.B, ss.src, ss.sa)


def _chunk_shape(plan, c: int):
    lo = plan.stream.layout
    return (lo.g_last if c == lo.n_chunks - 1 else lo.G), lo.W, lo.G * lo.W


def expand(plan, ops, c: int):
    """Chunk c's expand stage: (rid, col, val)."""
    ss = plan.stream
    Gc, W, CP = _chunk_shape(plan, c)
    sa_ch, b_rec = ops
    return _expand_chunk(ss.e, ss.p0, ss.su, sa_ch, ss.pend, b_rec, c * CP,
                         ss.sid_bases[c], Gc, W, plan.shape[1], CP,
                         ss.rowend, plan.cfg.stream_expand_impl)


def expand_sort(plan, ops, c: int, sort_impl: str):
    """Chunk c's expand and its (rid, col) sort (K2 whatever the name)."""
    rid, col, val = expand(plan, ops, c)
    return _sort_rect(rid, col, val, plan.shape[1], plan.stream.pack_bits,
                      sort_impl)


def chunk_is_raw(plan, c: int) -> bool:
    """Whether the counting loop stages chunk c raw (sorted, uncompacted:
    a contained-only chunk of a fused plan)."""
    ss = plan.stream
    return bool(ss.fused and c * ss.layout.G >= ss.layout.r_wide)


def chunk(plan, ops, c: int, sort_impl=None):
    """Chunk c as the counting loop runs it (``ops.spgemm.count_chunk``),
    on counts of zero: (nnz_row, staged)."""
    knobs = _knobs(plan.cfg)
    if sort_impl is not None:
        knobs["sort_impl"] = sort_impl
    nnz_row = torch.zeros(plan.shape[0] + 1, dtype=I32,
                          device=plan.stream.e.device)
    return count_chunk(plan.stream, ops, nnz_row, c, plan.shape[1], knobs)
