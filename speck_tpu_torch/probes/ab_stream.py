"""The stream's sort names and one chunk's sub-stages on the card, for
bench config 2: the port of ``scripts/ab_stream.py``.

    python -m speck_tpu_torch.probes.ab_stream [--reps N]

Bench config 2 (``make_powerlaw(131072, seed=5)``, A·A, float32).
``split`` times, in the script's order and under its labels: the
complete ``spgemm`` under each of the script's three sort names (the
default ``auto``, ``bitonic`` and ``bitonic_pallas``; every name runs
the one K2 sort on the card), ``plan_spgemm``
(the layout line after it), then on chunk ``min(1, n_chunks - 1)``: the
expand alone, the expand and its sort, the full chunk as the counting
loop calls it (a contained chunk of a fused plan stages raw), then
``stream_gather_emit`` of the staged chunks alone and ``execute()``. A
variant that fails raises: nothing is caught. Each row is the host clock
around the stage (median and min of ``--reps`` after one warm call,
ending in a synchronize) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from ..ops.device_csr import device_put_csr
from ..ops.spgemm import plan_spgemm, spgemm
from ..ops.stream import chunk_expand, stream_gather_emit
from ..utils.config import SpgemmConfig
from .split import chunk, chunk_operands, expand_sort, layout_line, \
    print_rows, start, timed

VARIANTS = (("xla/sort", "auto"), ("bitonic/sort", "bitonic"),
            ("bitonic_pallas/sort", "bitonic_pallas"))
LABELS = (tuple(f"config2 {name}" for name, _ in VARIANTS)
          + ("layout", "expand only", "expand+sort",
             "full chunk (stage_raw)", "gather emit", "execute() fused"))


def split(A, cfg=None, reps: int = 5):
    """The script's stages on A·A. Returns the rows; the chunk rows'
    outputs are those of chunk ``min(1, n_chunks - 1)``."""
    cfg = cfg or SpgemmConfig()
    rows = []
    for label, (_, impl) in zip(LABELS, VARIANTS):
        vcfg = dataclasses.replace(cfg, stream_sort_impl=impl)
        rows.append(timed(label, lambda vcfg=vcfg: spgemm(A, A, vcfg), reps))
    rows.append(timed(LABELS[3], lambda: plan_spgemm(A, A, cfg), reps))
    plan = rows[-1][3]
    ss = plan.stream
    if ss is None or not ss.fused or ss.staged is None:
        raise ValueError("ab_stream.split needs a fused stream plan "
                         "(bench config 2)")
    c = min(1, ss.layout.n_chunks - 1)
    rec = chunk_operands(plan)
    rows.append(timed(LABELS[4], lambda: chunk_expand(rec, c), reps))
    rows.append(timed(LABELS[5], lambda: expand_sort(rec, c), reps))
    rows.append(timed(LABELS[6], lambda: chunk(plan, rec, c), reps))
    flat = ss.staged_cat()
    rows.append(timed(LABELS[7], lambda: stream_gather_emit(
        ss.rows_sorted, ss.e, plan.row_offsets, *flat, W=ss.layout.W,
        nnz=plan.nnz), reps))
    rows.append(timed(LABELS[8], plan.execute, reps))
    return rows


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev, where = start(device)
    from ..utils.generators import make_powerlaw

    h = make_powerlaw(131072, seed=5)
    A = device_put_csr(h, torch.float32, device=dev)
    print(f"# ab_stream config 2: m={h.rows} nnz={h.nnz}, A*A float32, "
          f"fresh process [{where}]", flush=True)
    rows = split(A, reps=args.reps)
    print_rows(rows, where)
    plan = rows[3][3]
    print(f"# {layout_line(plan)}; chunk "
          f"{min(1, plan.stream.layout.n_chunks - 1)}; nnz={plan.nnz}",
          flush=True)


if __name__ == "__main__":
    main()
