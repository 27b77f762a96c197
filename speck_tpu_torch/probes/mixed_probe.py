"""Config 1b's planning split on the card: the port of
``scripts/mixed_probe.py``.

    python -m speck_tpu_torch.probes.mixed_probe [--reps N]

Bench config 1b (``make_mixed()``: a band with 1024 outlier rows, A·A,
float32). ``split`` times, in the script's order and under its labels:
the complete ``spgemm``; ``host_analyze``; ``plan_device_stream`` under
the three (per-row DIA split, dense tiles) variants, with plan_spgemm's
other arguments; ``plan_spgemm``, which decides the routes (its line
after it); ``execute()`` of the staged plan (nnz after it). Each row is
the host clock around the stage (median and min of ``--reps`` after one
warm call, ending in a synchronize) with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from ..ops.analysis import HostEnds, host_analyze
from ..ops.device_csr import device_put_csr, host_of
from ..ops.spgemm import plan_spgemm, plan_stream, spgemm
from ..utils.config import SpgemmConfig
from .split import print_rows, start, timed

VARIANTS = ((True, True), (False, True), (False, False))
LABELS = (("complete", "host_analyze")
          + tuple(f"plan_device_stream dia_rows={r} dense={d}"
                  for r, d in VARIANTS)
          + ("routes", "execute (staged)"))


def split(A, cfg=None, reps: int = 5):
    """The script's stages on A·A (A with its host copy attached)."""
    cfg = cfg or SpgemmConfig()
    ah = host_of(A)
    rows = [timed(LABELS[0], lambda: spgemm(A, A, cfg), reps),
            timed(LABELS[1], lambda: host_analyze(ah, ah, HostEnds()),
                  reps)]
    stats = rows[-1][3].to_device(A.device)
    for label, (dia_rows, dense) in zip(LABELS[2:5], VARIANTS):
        rows.append(timed(label, lambda dense=dense, dia_rows=dia_rows: (
            plan_stream(A, A, cfg, stats, use_dense=dense,
                        use_dia_rows=dia_rows)), reps))
    rows.append(timed(LABELS[5], lambda: plan_spgemm(A, A, cfg), reps))
    plan = rows[-1][3]
    rows.append(timed(LABELS[6], plan.execute, reps))
    return rows


def routes_line(plan) -> str:
    ss = plan.stream
    lo = ss.layout if ss else None
    return (f"routes: dia_rows={plan.dia_rows is not None} "
            f"dense={plan.dense is not None} "
            f"stream rows={lo.n_stream_rows if lo else 0} "
            f"n_chunks={lo.n_chunks if lo else 0} G={lo.G if lo else 0} "
            f"total_q={lo.total_q if lo else 0}")


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev, where = start(device)
    from ..utils.generators import make_mixed

    h = make_mixed()
    A = device_put_csr(h, torch.float32, device=dev)
    print(f"# mixed_probe config 1b: m={h.rows} nnz={h.nnz}, A*A float32, "
          f"fresh process [{where}]", flush=True)
    rows = split(A, reps=args.reps)
    print_rows(rows, where)
    plan = rows[5][3]
    print(f"# {routes_line(plan)}; nnz={plan.nnz}", flush=True)


if __name__ == "__main__":
    main()
