"""Gather variants and config 1's planning lines on the card: the port of
``scripts/micro2.py``.

    python -m speck_tpu_torch.probes.micro2 [--reps N]

The gather half: a 16M-entry table of (column, value) and 14M random
record indices (``np.random.RandomState(0)``), gathered as rows of one
(T, 2) int32 table (``rows(T,2)``, the value bits viewed back as float32)
and as two planes (``two-planes``); the script's ``complex64`` variant is
disabled there and not ported. Both are torch indexing, as the script
times XLA's gathers. Each line gives the host clock (median and min of
``--reps`` after one warm call, ending in a synchronize), the records a
second, and on a card the CUDA-event device time (median of ``--reps``);
the two variants must give equal bits.

The planning half: config 1 (``make_banded(65536, 16, seed=3)``, A·A,
float32) through ``profile_plan``'s planning calls: the device
``analyze``, ``tile_stats``, ``_plan_rows_impl``, ``plan_device_stream``
with the dense-tile gate and without. Every line carries the card's name
and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.analysis import analyze
from ..ops.device_csr import device_put_csr
from ..utils.config import SpgemmConfig
from .profile_plan import planning_calls
from .split import print_rows, start, timed
from .timing import cuda_ms

GATHER_LABELS = ("gather rows(T,2)", "gather two-planes")
PLAN_LABELS = ("analyze", "tile_stats", "_plan_rows_impl(tight)",
               "plan_device_stream full", "plan_device_stream use_dense=False")
T_DEFAULT, N_DEFAULT = 16 << 20, 14 << 20


def gather_inputs(device, T: int = T_DEFAULT, N: int = N_DEFAULT):
    """The script's table and indices: (cols, vals, src)."""
    rs = np.random.RandomState(0)
    cols = rs.randint(0, 1 << 20, T).astype(np.int32)
    vals = rs.standard_normal(T).astype(np.float32)
    src = rs.randint(0, T, N).astype(np.int32)
    return tuple(torch.as_tensor(x, device=device) for x in (cols, vals, src))


def gather_calls(cols, vals, src):
    """{label: zero-argument call} of the two variants, each giving
    (columns, values)."""
    packed2 = torch.stack([cols, vals.view(torch.int32)], dim=-1)
    srcl = src.long()

    def g_rows():
        r = packed2[srcl]
        return r[:, 0], r[:, 1].contiguous().view(torch.float32)

    return {GATHER_LABELS[0]: g_rows,
            GATHER_LABELS[1]: lambda: (cols[srcl], vals[srcl])}


def gather_split(cols, vals, src, reps: int = 5):
    return [timed(label, fn, reps)
            for label, fn in gather_calls(cols, vals, src).items()]


def plan_split(A, cfg=None, reps: int = 5):
    """Config 1's planning lines, in the script's order."""
    cfg = cfg or SpgemmConfig()
    calls = planning_calls(A, cfg, analyze(A, A))
    names = ("analyze", "tile_stats", "_plan_rows_impl",
             "plan_device_stream", "plan_device_stream use_dense=False")
    return [timed(label, calls[name], reps)
            for label, name in zip(PLAN_LABELS, names)]


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev, where = start(device)
    cols, vals, src = gather_inputs(dev)
    N = src.shape[0]
    rows = gather_split(cols, vals, src, args.reps)
    (c0, v0), (c1, v1) = rows[0][3], rows[1][3]
    if not (torch.equal(c0, c1) and torch.equal(v0.view(torch.int32),
                                                v1.view(torch.int32))):
        raise AssertionError("the two gather variants differ")
    calls = gather_calls(cols, vals, src)
    for label, med, mn, _ in rows:
        ev = (f", device {cuda_ms(calls[label], args.reps):.3f} ms by CUDA "
              f"events" if dev.type == "cuda" else "")
        print(f"# {label}: median {med:.3f} ms, min {mn:.3f} ms "
              f"({N / mn / 1e3:.0f}M rec/s){ev} [{where}]", flush=True)
    print("# gather outputs identical", flush=True)
    from ..utils.generators import make_banded

    A = device_put_csr(make_banded(), torch.float32, device=dev)
    print_rows(plan_split(A, reps=args.reps), where)


if __name__ == "__main__":
    main()
