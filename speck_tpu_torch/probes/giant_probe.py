"""One giant-row chunk's sub-stages on the card: the port of
``scripts/giant_probe.py``.

    python -m speck_tpu_torch.probes.giant_probe [--reps N]

The bench's giant row (``make_giant_row()``: 40,000 rows, 50,084,873
nonzeros, 5 * 10^7 products in row 0), A·A, float32, default
``SpgemmConfig``. ``split`` times, in the script's order and under its
labels: the full ``plan_spgemm`` (the layout line after it); chunk 0's
expand alone; the expand and its sort under each of the script's sort
names (``xla``, ``blocked``, ``auto``); the full chunk (expand, sort, K1
contract, count, compaction) as the counting loop calls it, under
``xla`` and ``auto``; the merge-level plans (``plan_levels``), with the
finish classes that the counting pass recorded. Every sort name is the
one stable sort, K2 on the card: the probe keeps the script's lines, each
a run of that sort, and prints the K2 launches. Each row is the host
clock around the stage (median and min of ``--reps`` after one warm
call, ending in a synchronize) with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import bitonic
from ..ops.device_csr import device_put_csr
from ..ops.spgemm import plan_spgemm
from ..ops.stream import chunk_expand, plan_levels
from ..utils.config import SpgemmConfig
from .split import chunk, chunk_operands, expand_sort, layout_line, \
    print_rows, start, timed

SORTS = ("xla", "blocked", "auto")
CHUNK_SORTS = ("xla", "auto")
LABELS = (("full plan_spgemm", "expand only")
          + tuple(f"expand+sort[{s}]" for s in SORTS)
          + tuple(f"full chunk (stage, compact)[{s}]" for s in CHUNK_SORTS)
          + ("level plans and finish classes",))


def split(A, cfg=None, reps: int = 5, c: int = 0):
    """The script's stages on A·A, on chunk ``c`` (the script's 0: every
    wide-row segment). The level row's outputs are (level plans, the
    finish classes as (R2, W2))."""
    cfg = cfg or SpgemmConfig()
    rows = [timed(LABELS[0], lambda: plan_spgemm(A, A, cfg), reps)]
    plan = rows[0][3]
    ss = plan.stream
    rec = chunk_operands(plan)
    rows.append(timed(LABELS[1], lambda: chunk_expand(rec, c), reps))
    for label in LABELS[2:5]:
        rows.append(timed(label, lambda: expand_sort(rec, c), reps))
    for label in LABELS[5:7]:
        rows.append(timed(label, lambda: chunk(plan, rec, c), reps))
    classes = [(f["R2"], f["W2"])
               for f in (ss.finish or {}).get("classes") or []]
    rows.append(timed(LABELS[7], lambda: (plan_levels(
        ss.layout, F=cfg.stream_level_factor,
        max_width=cfg.stream_max_width), classes), reps))
    return rows


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev, where = start(device)
    from ..utils.generators import make_giant_row

    h = make_giant_row()
    A = device_put_csr(h, torch.float32, device=dev)
    print(f"# giant_probe: m={h.rows} nnz={h.nnz}, A*A float32, fresh "
          f"process [{where}]", flush=True)
    k2_before = bitonic.LAUNCHES
    rows = split(A, reps=args.reps)
    print_rows(rows, where)
    plan = rows[0][3]
    lplans, classes = rows[-1][3]
    print(f"# {layout_line(plan)}; nnz={plan.nnz}", flush=True)
    print(f"# n lplans={len(lplans)}, finish classes={classes}", flush=True)
    print(f"# every sort name ran K2 (row_sort), "
          f"{bitonic.LAUNCHES - k2_before} launches in the split [{where}]",
          flush=True)


if __name__ == "__main__":
    main()
