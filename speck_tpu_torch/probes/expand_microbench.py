"""Expand-stage data movement on the card: the port of
``scripts/expand_microbench.py``.

Its Pallas run copy (``run_pallas``, :121) computes the same function as
``gather_microbench2.py``'s ``runf``, so both are ``run_copy`` of
``gather_microbench2``. ``main()`` times, with plain torch, the script's
XLA-side measurements (a, c, d: 8-byte record gathers with random, sorted
and run-structured indices; b: 16-, 32- and 64-byte records at the same
bytes), then the run copy kernel beside the same pattern as one indexing
call, one line each with the card's name and power limit:

    python -m speck_tpu_torch.probes.expand_microbench [n_slots_log2=22]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .gather_microbench2 import run_copy


def main(argv=None):
    from ..utils.device import resolve_device
    from .timing import card, cuda_ms, report

    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(None)
    smi = card()
    N = 1 << (int(argv[0]) if argv else 22)   # gather slots
    NB = 1 << 21                               # table entries
    rs = np.random.RandomState(0)
    put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    idx_rand = rs.randint(0, NB - 64, N).astype(np.int32)
    starts = rs.randint(0, NB - 64, N // 10 + 1).astype(np.int32)
    runs = (np.repeat(starts, 10)[:N]
            + np.tile(np.arange(10, dtype=np.int32), N // 10 + 1)[:N])
    tab2 = put(rs.randint(0, 1 << 30, (NB, 2)).astype(np.int32))
    for name, ix in (("a_8B_random", idx_rand),
                     ("c_8B_sorted", np.sort(idx_rand)),
                     ("d_8B_runs", runs)):
        d = put(ix)
        report(name, cuda_ms(lambda: tab2[d]), N, N * 8, smi)
    # b. wider records, same total bytes
    for w in (4, 8, 16):
        tabw = put(rs.randint(0, 1 << 30, (NB // w * 2, w)).astype(np.int32))
        idxw = put(rs.randint(0, NB // w * 2 - 1, N // w).astype(np.int32))
        report(f"b_{w * 4}B_random_samebytes", cuda_ms(lambda: tabw[idxw]),
               N // w, N * 4, smi)

    # e. the run copy kernel against the same pattern as one gather
    G, K, L = 512, 64, 128
    src = put(rs.standard_normal(NB).astype(np.float32))
    offs = put(rs.randint(0, NB - L, (G, K)).astype(np.int32))
    ix = (offs.long().reshape(-1, 1)
          + torch.arange(L, device=dev)).reshape(-1)
    if not torch.equal(run_copy(offs, src, L), src[ix]):
        raise RuntimeError("run_copy differs from the indexing call")
    report("e_run_copy128_kernel", cuda_ms(lambda: run_copy(offs, src, L)),
           G * K * L, G * K * L * 8, smi)
    report("e_indexing_same_pattern", cuda_ms(lambda: src[ix]), G * K * L,
           G * K * L * 8, smi)


if __name__ == "__main__":
    main()
