"""What the stage probes share: the row of a stage and its line, the
probe's device, and the counting calls of a plan: a chunk as
``ops.spgemm.plan_spgemm``'s counting loop runs it (``count_chunk``, on
the plan's records bound by ``_stream_operands``), and its expand and
sort stages as ``stream.chunk_sorted`` runs them, so that a probe times
the calls the plan makes. The planning calls are ``ops.spgemm``'s own
(``lite_gate``, ``host_gates``, ``plan_stream``, ``host_layout``,
``stream_records``).

A row is (label, median ms, min ms, outputs): the host clock around the
stage (``timing.host_ms``: one warm call, then the repetitions, each
ending in a synchronize on a card), and the last call's outputs.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..ops.spgemm import _stream_operands, count_chunk
from ..ops.stream import _sort_rect, chunk_expand
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
    """The plan's chunk records with the expand's operands bound, as the
    counting loop takes them."""
    return _stream_operands(plan.A, plan.B, plan.stream.rec)


def expand_sort(rec, c: int):
    """Chunk c's expand and its (rid, col) sort (K2)."""
    rid, col, val = chunk_expand(rec, c)
    return _sort_rect(rid, col, val, rec.n_cols, rec.pack_bits)


def chunk_is_raw(plan, c: int) -> bool:
    """Whether the counting loop stages chunk c raw (sorted, uncompacted:
    a contained-only chunk of a fused plan)."""
    ss = plan.stream
    return bool(ss.fused and c * ss.layout.G >= ss.layout.r_wide)


def chunk(plan, rec, c: int):
    """Chunk c as the counting loop runs it (``ops.spgemm.count_chunk``),
    on counts of zero: (nnz_row, staged)."""
    nnz_row = torch.zeros(plan.shape[0] + 1, dtype=I32,
                          device=plan.stream.e.device)
    return count_chunk(plan.stream, rec, nnz_row, c,
                       plan.cfg.stream_compact_impl)
