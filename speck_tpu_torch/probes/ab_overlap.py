"""A/B of the mesh's need-set exchange, plain against overlapped, on the
card: the port of ``scripts/ab_overlap.py``.

    python -m speck_tpu_torch.probes.ab_overlap [m] [iters] [--out DIR]

``make_powerlaw(m, avg=8, seed=5)`` (default m = 65536), A·A, float32,
through ``mesh_stream_spgemm`` under ``exchange="needset"`` and
``"needset_overlap"`` with ``SpgemmConfig(mesh_exchange_auto=False)`` on
an 8-shard row mesh: a shard a card where 8 cards are present, else the
8 shards on one card (``make_row_mesh(8, devices=["cuda:0"])``), where
they run in turns and no byte crosses a link. Each exchange's first call
(host planning and the step) is timed, then the step alone, re-run
through ``mesh_stream.last_exec()`` (the cached step on its arguments,
no host planning): median and min of ``iters`` after one warm call, the
host clock ending in a synchronize of every card. Both must give the
same C.

In place of the script's optimized-HLO schedule: the device events of
one profiled overlapped step (``torch.profiler``), in start order: K2's
launches (``row_sort``'s kernels) and the exchange's copies, which are
the device work of the step's labelled landing of a permuted round
(``mesh_stream.EXCHANGE_LABEL``) and any peer copy or NCCL kernel; the
sorts before the first exchange copy are counted. Writes
``overlap_ab.md`` and ``overlap_sched.txt`` under ``--out`` (default
``build/speck_tpu_torch/probes/`` beside the package); each line printed
carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..parallel import (make_row_mesh, mesh_stream_spgemm,
                        mesh_stream_to_host_csr)
from ..parallel import mesh_stream
from ..utils.config import SpgemmConfig
from .split import start, timed

MODES = ("needset", "needset_overlap")
OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "speck_tpu_torch" \
    / "probes"
K2_KERNELS = ("radix_tile_kernel", "merge_pass_kernel")


def mesh_of(device, shards: int = 8):
    """The 8-shard row mesh: a shard a card where there are enough cards,
    else every shard on ``device``."""
    if device.type == "cuda" and torch.cuda.device_count() >= shards:
        return make_row_mesh(shards)
    return make_row_mesh(shards, devices=[str(device)])


def _sync(mesh):
    for d in {d for d in mesh.devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def split(a, mesh, cfg=None, iters: int = 3):
    """One row per exchange (``MODES``): the cached step's median and min
    over ``iters`` after one warm call; outputs a dict of the first
    call's ms, nnz(C), the call's output and the cached step."""
    cfg = cfg or SpgemmConfig(mesh_exchange_auto=False)
    rows = []
    for mode in MODES:
        _sync(mesh)
        t0 = time.perf_counter()
        out = mesh_stream_spgemm(a, a, mesh, cfg=cfg, exchange=mode)
        _sync(mesh)
        first = (time.perf_counter() - t0) * 1e3
        fn, args = mesh_stream.last_exec()

        def step(fn=fn, args=args):
            r = fn(*args)
            _sync(mesh)
            return r
        label, med, mn, _ = timed(mode, step, iters)
        rows.append((label, med, mn, dict(
            first_ms=first, nnz=int(out[0].sum()), out=out,
            step=(fn, args))))
    return rows


def host_c(row):
    """A row's C on the host."""
    return mesh_stream_to_host_csr(*row[3]["out"])


def check_equal(rows) -> None:
    """The two exchanges' C must be equal, structure and values."""
    a, b = host_c(rows[0]), host_c(rows[1])
    if not (np.array_equal(a.row_offsets, b.row_offsets)
            and np.array_equal(a.col_ids, b.col_ids)
            and np.array_equal(a.data, b.data)):
        raise AssertionError("needset and needset_overlap give different C")


def schedule(fn, args):
    """The device events of one profiled call of the overlapped step, in
    start order: [(kind, name, label)] with kind "K2" or "exchange copy",
    the sorts before the first exchange copy (None without a copy) and
    the exchange's labelled ranges seen on the host."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    evs = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in evs if e.device_type() == cpu
              and e.name().startswith(mesh_stream.EXCHANGE_LABEL)]
    op_start = {e.correlation_id(): e.start_ns() for e in evs
                if e.device_type() == cpu}

    def label_of(e):
        t = op_start.get(e.linked_correlation_id())
        if t is None:
            return None
        inside = [r for r in ranges if r[0] <= t <= r[1]]
        return min(inside, key=lambda r: r[1] - r[0])[2] if inside else None

    entries = []
    for e in sorted((e for e in evs if e.device_type() != cpu),
                    key=lambda e: e.start_ns()):
        name = e.name()
        label = label_of(e)
        if any(k in name for k in K2_KERNELS):
            entries.append(("K2", name, label))
        elif ("PtoP" in name or "nccl" in name.lower()
              or (label is not None and " land round " in label
                  and not label.endswith(" round 0"))):
            entries.append(("exchange copy", name, label))
    first = next((i for i, en in enumerate(entries)
                  if en[0] == "exchange copy"), None)
    before = (None if first is None
              else sum(1 for en in entries[:first] if en[0] == "K2"))
    return entries, before, ranges


def write_reports(rows, sched, m: int, iters: int, mesh, where: str,
                  out_dir: Path):
    entries, before, _ = sched
    out_dir.mkdir(parents=True, exist_ok=True)
    n_copies = sum(1 for en in entries if en[0] == "exchange copy")
    with open(out_dir / "overlap_sched.txt", "w") as fh:
        fh.write("# device events of one profiled needset_overlap step, in "
                 "start order: K2's launches and the exchange's copies "
                 f"[{where}]\n")
        for i, (kind, name, label) in enumerate(entries):
            fh.write(f"{i:6d}  {kind:13s}  {name[:90]}  {label or ''}\n")
    ns, ov = rows[0], rows[1]
    cards = sorted({str(d) for d in mesh.devices})
    shared = len(cards) < mesh.size
    with open(out_dir / "overlap_ab.md", "w") as fh:
        fh.write(
            f"# needset vs needset_overlap A/B ({mesh.size}-shard row mesh "
            f"on {', '.join(cards)}, power-law m={m}) [{where}]\n\n"
            f"| mode | first call | warm step median (min) of {iters} "
            f"| nnz(C) |\n|---|---|---|---|\n"
            f"| needset | {ns[3]['first_ms']:.1f} ms | {ns[1]:.1f} "
            f"({ns[2]:.1f}) ms | {ns[3]['nnz']} |\n"
            f"| needset_overlap | {ov[3]['first_ms']:.1f} ms | {ov[1]:.1f} "
            f"({ov[2]:.1f}) ms | {ov[3]['nnz']} |\n\n"
            f"overlap/needset ratio of the medians: {ov[1] / ns[1]:.3f}\n\n"
            f"Schedule: overlap_sched.txt, {n_copies} exchange copies, "
            f"{before} K2 sorts before the first of them (None: no copy).\n\n"
            + ("The shards share one card, so they run in turns and no "
               "byte crosses a link: a permuted round is the sent tensor "
               "itself, and its copy is the landing into the receiving "
               "shard's buffer; the order above shows which sorts need no "
               "permuted round, not an overlap in time.\n" if shared else
               "A shard a card: a permuted round is a peer copy on each "
               "card's copy stream, which the sorts queued meanwhile can "
               "overlap.\n"))


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("m", nargs="?", type=int, default=65536)
    ap.add_argument("iters", nargs="?", type=int, default=3)
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    args = ap.parse_args(argv)
    dev, where = start(device)
    from ..utils.generators import make_powerlaw

    a = make_powerlaw(args.m, avg=8, seed=5)
    mesh = mesh_of(dev)
    rows = split(a, mesh, iters=args.iters)
    check_equal(rows)
    for label, med, mn, o in rows:
        print(f"# {label}: first {o['first_ms']:.1f} ms, warm step median "
              f"{med:.1f} ms, min {mn:.1f} ms, nnz={o['nnz']} [{where}]",
              flush=True)
    sched = schedule(*rows[1][3]["step"])
    write_reports(rows, sched, args.m, args.iters, mesh, where, args.out)
    print(f"# schedule: {len(sched[0])} events, "
          f"{sum(1 for e in sched[0] if e[0] == 'K2')} K2 launches, "
          f"{sched[1]} before the first exchange copy; wrote "
          f"{args.out / 'overlap_ab.md'}, {args.out / 'overlap_sched.txt'} "
          f"[{where}]", flush=True)


if __name__ == "__main__":
    main()
