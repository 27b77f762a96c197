"""Is a slice gather (N run starts x RW contiguous elements) cheaper than
an element gather of the same volume? The port of
``scripts/slice_gather_bench.py`` to the card:

    python -m speck_tpu_torch.probes.slice_gather_bench [M] [RW] [--reps N]

M products (default 2^22), runs of RW (default 16) over a table of NN =
2^21 int32 entries, from ``np.random.RandomState(0)`` as the script:

  A. element gather: out[i] = tab[idx[i]], M random indices
  B. slice gather: out[n, j] = tab[st[n] + j], N = M / RW starts
  C. packed element gather from an (NN, 2) table
  D. packed slice gather, (N, RW, 2)
  E. the script's ``lax.gather`` of RW-slices in CLIP mode

The starts of B, D and E are clamped to [0, NN - RW], as XLA clamps the
start of a ``dynamic_slice`` and of a CLIP gather. Each is torch
indexing, as the script times XLA's gathers, not a Pallas kernel. Each
line gives the host clock (median and min of ``--reps`` after one warm
call, ending in a synchronize), ns an element and a start, and on a card
the CUDA-event device time, with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .split import start, timed
from .timing import cuda_ms

LABELS = ("A element gather", "B slice gather", "C packed element gather",
          "D packed slice gather", "E lax.gather slices")
NN_DEFAULT = 1 << 21


def inputs(M: int, RW: int, device, NN: int = NN_DEFAULT):
    """The script's (tab, tab2, idx, st)."""
    rs = np.random.RandomState(0)
    tab = rs.randint(0, 1 << 30, NN, dtype=np.int32)
    tab2 = rs.randint(0, 1 << 30, (NN, 2), dtype=np.int32)
    idx = rs.randint(0, NN, M, dtype=np.int32)
    st = rs.randint(0, NN - RW, M // RW, dtype=np.int32)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (tab, tab2, idx, st))


def calls(tab, tab2, idx, st, RW: int):
    """{label: zero-argument call} of A-E."""
    NN = tab.shape[0]
    run = torch.arange(RW, dtype=torch.int64, device=tab.device)
    idxl = idx.long()

    def slices():
        return torch.clamp(st.long(), 0, NN - RW)[:, None] + run

    return {LABELS[0]: lambda: tab[idxl],
            LABELS[1]: lambda: tab[slices()],
            LABELS[2]: lambda: tab2[idxl],
            LABELS[3]: lambda: tab2[slices()],
            LABELS[4]: lambda: tab[slices()]}


def split(tab, tab2, idx, st, RW: int, reps: int = 5):
    return [timed(label, fn, reps)
            for label, fn in calls(tab, tab2, idx, st, RW).items()]


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("M", nargs="?", type=int, default=1 << 22)
    ap.add_argument("RW", nargs="?", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev, where = start(device)
    M, RW = args.M, args.RW
    arrays = inputs(M, RW, dev)
    N = M // RW
    fns = calls(*arrays, RW)
    for label, med, mn, _ in split(*arrays, RW, args.reps):
        per = (f"{mn / M * 1e6:.3f} ns/elem" if label[0] in "AC" else
               f"{mn / (N * RW) * 1e6:.3f} ns/elem, {mn / N * 1e6:.3f} "
               f"ns/start")
        ev = (f", device {cuda_ms(fns[label], args.reps):.4f} ms by CUDA "
              f"events" if dev.type == "cuda" else "")
        print(f"# {label} M={M} RW={RW}: median {med:.4f} ms, min "
              f"{mn:.4f} ms ({per}){ev} [{where}]", flush=True)


if __name__ == "__main__":
    main()
