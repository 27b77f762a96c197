"""Config 4's stage split on the card: the port of
``scripts/rect_probe.py``.

    python -m speck_tpu_torch.probes.rect_probe [--reps N]

Bench config 4 (config 1's A, ``make_banded(65536, 16, seed=3)``, times
``make_prolongation(65536, 16384)``, float32). ``split`` times, in the
script's order and under its labels: the complete ``spgemm``;
``plan_spgemm`` (the layout line after it); the B record pack
(``_stream_operands``, as the counting loop makes it); every counting
chunk as plan_spgemm's loop calls it (``count_chunk``: expand, K2 sort,
K1 contract, count and staging); ``build_srec`` compacted with separate
gathers, then uncompacted with the 8-byte record gathers (the
reference's ``pack_gathers``, here ``build_srec_packed``), the script's
two variants, then the other two
(compacted and packed, uncompacted and separate), so that each option is
timed at either value of the other; ``execute()`` of the staged plan. Each row is the
host clock around the stage (median and min of ``--reps`` after one warm
call, ending in a synchronize) with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.device_csr import device_put_csr
from ..ops.spgemm import plan_spgemm, record_bits, spgemm
from ..ops.stream import build_srec, srec_finish, srec_slots
from ..utils.config import SpgemmConfig
from .split import chunk, chunk_operands, layout_line, print_rows, start, \
    timed

SREC_VARIANTS = ((True, False), (False, True), (True, True),
                 (False, False))
LABELS = (("spgemm complete", "layout", "pack B", "counting chunks")
          + tuple(f"build_srec (compact={c}, pack={p})"
                  for c, p in SREC_VARIANTS)
          + ("execute (staged gather emit)",))


def build_srec_packed(a_indptr, a_indices, a_data32, b_start, b_len,
                      rows_sorted, e, q_sorted, *, m: int, nl=None,
                      compact: bool = True):
    """``build_srec`` with the reference's ``pack_gathers``: (A column, A
    value bits) and (B row start, B row length) read as 8-byte records,
    two random reads in place of four; the same records. The port keeps
    the separate gathers (no gain on the card: PERF.md)."""
    slots = srec_slots(a_indptr, rows_sorted, q_sorted,
                       nnz=a_indices.shape[0], m=m, nl=nl)
    arec = torch.stack([a_indices, a_data32], dim=-1)[slots[3]]
    brec = torch.stack([b_start, b_len], dim=-1)[arec[:, 0]]
    return srec_finish(e, slots, arec[:, 1], brec[:, 0], brec[:, 1],
                       compact=compact)


def split(A, B, cfg=None, reps: int = 5):
    """The script's stages on A·B. The counting chunks' outputs are
    (nnz_row, staged) a chunk."""
    cfg = cfg or SpgemmConfig()
    rows = [timed(LABELS[0], lambda: spgemm(A, B, cfg), reps),
            timed(LABELS[1], lambda: plan_spgemm(A, B, cfg), reps)]
    plan = rows[-1][3]
    ss = plan.stream
    rows.append(timed(LABELS[2], lambda: chunk_operands(plan), reps))
    rec = rows[-1][3]
    rows.append(timed(LABELS[3], lambda: [
        chunk(plan, rec, c) for c in range(ss.layout.n_chunks)], reps))
    m = plan.shape[0]
    a32 = record_bits(A)
    n_srec = len(SREC_VARIANTS)
    for label, (comp, pg) in zip(LABELS[4:4 + n_srec], SREC_VARIANTS):
        fn = build_srec_packed if pg else build_srec
        rows.append(timed(label, lambda comp=comp, fn=fn: fn(
            A.indptr, A.indices, a32, B.indptr[:-1],
            B.indptr[1:] - B.indptr[:-1], ss.rows_sorted, ss.e, ss.q_sorted,
            m=m, nl=ss.rec.p0.shape[0], compact=comp), reps))
    rows.append(timed(LABELS[-1], plan.execute, reps))
    return rows


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev, where = start(device)
    from ..utils.generators import make_banded, make_prolongation

    a, p = make_banded(), make_prolongation(65536, 16384)
    A = device_put_csr(a, torch.float32, device=dev)
    B = device_put_csr(p, torch.float32, device=dev)
    print(f"# rect_probe config 4: A {a.rows}x{a.cols} nnz={a.nnz}, P "
          f"{p.rows}x{p.cols}, float32, fresh process [{where}]", flush=True)
    rows = split(A, B, reps=args.reps)
    print_rows(rows, where)
    plan = rows[1][3]
    lo = plan.stream.layout
    print(f"# {layout_line(plan)}; counting chunks {lo.n_chunks} x "
          f"({lo.G}, {lo.W}); build_srec nl={plan.stream.rec.p0.shape[0]}; "
          f"nnz={plan.nnz}", flush=True)


if __name__ == "__main__":
    main()
