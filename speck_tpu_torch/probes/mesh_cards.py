"""The row mesh with one shard a card, over the cards of one process:

    python -m speck_tpu_torch.probes.mesh_cards              # every card
    python -m speck_tpu_torch.probes.mesh_cards --devices cpu --shards 4 \\
        --rows 8192                                          # a rehearsal

Bench config 3 (``make_powerlaw(262144, seed=7)``, A·A, float32) through
``mesh_stream_spgemm`` under ``exchange="needset"``, ``"needset_overlap"``
and ``"allgather"``, each checked once against the scipy oracle (structure
exact, values within rel_tol 2e-3), then timed in turns: one warm-up call
each, then ``--reps`` rounds that call each exchange once, in order on
even rounds and reversed on odd ones. A time is the host clock around one
complete call, ending in a synchronize of every card. Across cards the
need-set rounds are peer copies between the cards, issued on each card's
copy stream by the overlapped exchange, so this is where it can differ
from the plain one (four shards on one card move nothing). Each line
carries every card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch


def _sync(devs):
    for d in {d for d in devs if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def main(argv=None) -> None:
    import speck_tpu_torch as pt
    from speck_tpu_torch.parallel import (make_row_mesh, mesh_stream_spgemm,
                                          mesh_stream_to_host_csr)
    from speck_tpu_torch.probes.timing import card
    from speck_tpu_torch.utils.generators import make_powerlaw

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="*", default=None,
                    help="the mesh's devices (default: every CUDA card)")
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--rows", type=int, default=262144)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    mesh = make_row_mesh(args.shards, devices=args.devices)
    cards = "not a card" if all(d.type != "cuda" for d in mesh.devices) \
        else card()
    h = make_powerlaw(args.rows, 12, 2.2, 7)
    ref = pt.oracle_spgemm(h, h)
    calls = {ex: (lambda ex=ex: mesh_stream_spgemm(h, h, mesh,
                                                    exchange=ex))
             for ex in ("needset", "needset_overlap", "allgather")}
    stats = {}
    for ex, fn in calls.items():
        out = fn()
        r = pt.compare_csr(ref, mesh_stream_to_host_csr(*out),
                           compare_data=True, rel_tol=2e-3)
        if not r.ok:
            raise RuntimeError(f"{ex} differs from the oracle: {r.message}")
        st = out[3]["stats"]
        stats[ex] = (st.mode, st.needset_bytes) if st else ("allgather",
                                                              None)
    times = {ex: [] for ex in calls}
    names = list(calls)
    for rep in range(args.reps):
        for ex in (names if rep % 2 == 0 else names[::-1]):
            _sync(mesh.devices)
            t0 = time.perf_counter()
            calls[ex]()
            _sync(mesh.devices)
            times[ex].append((time.perf_counter() - t0) * 1e3)
    print(f"mesh over {mesh.size} shards on "
          f"{[str(d) for d in mesh.devices]} [{cards}]: config 3 "
          f"(m={h.rows}, nnz={h.nnz}) A*A float32, every exchange matches "
          f"the oracle", flush=True)
    for ex, ts in times.items():
        mode, nb = stats[ex]
        print(f"  {ex}: mode {mode}, needset_bytes {nb}; warm median of "
              f"{len(ts)} in turns {statistics.median(ts):.2f} ms (all "
              f"{[round(t, 2) for t in ts]})", flush=True)


if __name__ == "__main__":
    main()
