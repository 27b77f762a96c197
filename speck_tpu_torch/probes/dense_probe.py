"""The dense tiles' sub-stages on the card: the port of
``scripts/dense_probe.py``.

    python -m speck_tpu_torch.probes.dense_probe [config4|dense_banded]
        [--reps N]

``config4`` (the script's: config 1's A, ``make_banded(65536, 16,
seed=3)``, times ``make_prolongation(65536, 16384)``, float32) and
``dense_banded`` (config 1 times itself under ``enable_dia=False``, the
dense-banded cell of ``chip_smoke.py``'s phase 7e). The plan's dense
group is printed first; where the plan has none (its tiles' windows do
not pass the gate), the probe says so, as the script does, and stops.

``split`` times, on the group's first batch, in the script's order and
under its labels: ``dense_tiles`` whole, then its stages
(``ops/dense.py``): A's rectangle gather (``tile_gather_a``, one packed
record gather a nonzero); A's densify (``tile_densify``, two K2 sorts);
B's gather and densify; the product pair (``tile_products``: the
float32 ``torch.bmm`` with TF32 off, and the bfloat16 pattern ``bmm``;
the reference computes this pair with ``jnp.einsum``, outside any
Pallas kernel); the rank compaction (``tile_compact``, one K2 sort).
The stages compose to ``dense_tiles``'s output. Each row is the host clock around the stage (median and min of
``--reps`` after one warm call, ending in a synchronize) with the card's
name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.dense import dense_tiles, tile_compact, tile_densify, \
    tile_gather_a, tile_gather_b, tile_products
from ..ops.device_csr import device_put_csr
from ..ops.spgemm import _dense_operands, plan_spgemm
from ..utils.config import SpgemmConfig
from .split import print_rows, start, timed

I32 = torch.int32
LABELS = ("dense_tiles whole", "A gather_rect", "A densify_sorted",
          "B gather_rect", "B densify_sorted", "einsum pair (bmm pair)",
          "compaction sort")
CELLS = ("config4", "dense_banded")


def group_line(plan) -> str:
    d = plan.dense
    if d is None:
        return "dense grp: False"
    return (f"dense grp: kw={d.kw} cw={d.cw} la={d.la} lb={d.lb} "
            f"tiles={len(d.r0s)} batches={len(d.boffs) - 1} "
            f"full={d.full_cover}")


def split(plan, reps: int = 5):
    """The script's stages on the first batch of ``plan``'s dense group,
    each one of ``dense_tiles``'s own stages (``ops/dense.py``), so that
    they compose to its output. The compaction's outputs are (counts,
    cols, vals) as ``dense_tiles`` returns them."""
    A, B, d = plan.A, plan.B, plan.dense
    m, k_dim, n = A.shape[0], A.shape[1], B.shape[1]
    r0s, kbs, cbs, _ = next(iter(d.batches()))
    apk, bpk = _dense_operands(A, B)
    TR, kw, cw, la, lb = d.tile_rows, d.kw, d.cw, d.la, d.lb
    rows = [timed(LABELS[0], lambda: dense_tiles(
        r0s, kbs, cbs, A.indptr, A.indices, A.data, B.indptr, B.indices,
        B.data, torch.zeros(m + 1, dtype=I32, device=A.device), apk, bpk,
        tile_rows=TR, kw=kw, cw=cw, la=la, lb=lb, m=m, k_dim=k_dim,
        n_cols=n, densify="sort"), reps)]
    rows.append(timed(LABELS[1], lambda: tile_gather_a(
        r0s, A.indptr, A.indices, A.data, apk, tile_rows=TR, la=la, m=m),
        reps))
    _, vrow, (acol, aval, alive) = rows[-1][3]
    rows.append(timed(LABELS[2], lambda: tile_densify(
        acol, aval, alive, kbs, TR, kw), reps))
    A_dense, A_hit = rows[-1][3]
    rows.append(timed(LABELS[3], lambda: tile_gather_b(
        kbs, B.indptr, B.indices, B.data, bpk, kw=kw, lb=lb, k_dim=k_dim),
        reps))
    bcol, bval, blive = rows[-1][3]
    rows.append(timed(LABELS[4], lambda: tile_densify(
        bcol, bval, blive, cbs, kw, cw), reps))
    B_dense, B_hit = rows[-1][3]
    rows.append(timed(LABELS[5], lambda: tile_products(
        A_dense, A_hit, B_dense, B_hit, tile_rows=TR, kw=kw, cw=cw), reps))
    C_vals, C_cnt = rows[-1][3]
    rows.append(timed(LABELS[6], lambda: tile_compact(
        C_vals, C_cnt, vrow, cbs, tile_rows=TR, cw=cw, n_cols=n), reps))
    return rows


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell", nargs="?", default="config4", choices=CELLS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev, where = start(device)
    from ..utils.generators import make_banded, make_prolongation

    a = make_banded()
    A = device_put_csr(a, torch.float32, device=dev)
    if args.cell == "config4":
        B = device_put_csr(make_prolongation(65536, 16384), torch.float32,
                           device=dev)
        cfg = SpgemmConfig()
    else:
        B, cfg = A, SpgemmConfig(enable_dia=False)
    plan = plan_spgemm(A, B, cfg)
    print(f"# dense_probe {args.cell}: {group_line(plan)} [{where}]",
          flush=True)
    if plan.dense is None:
        print("# no dense group; counting is elsewhere", flush=True)
        return 0
    d = plan.dense
    print(f"# first batch: K={d.boffs[1]} tiles, TR={d.tile_rows}, "
          f"kw={d.kw}, cw={d.cw}, la={d.la}, lb={d.lb}; fresh process",
          flush=True)
    print_rows(split(plan, reps=args.reps), where)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
