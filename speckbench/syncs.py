"""The synchronizing operations of one call of a cell, beside the
readbacks the program counted for it:

    python3 -m speckbench.syncs --workload <cell> --seed <n> [--out FILE]

A fresh process sets the cell up as ``run.py`` does (inputs from the seed,
one warm call), then makes one more call under
``torch.cuda.set_sync_debug_mode("warn")``. It prints the synchronizing
operations torch reports, by the program's innermost lines that made each,
and the readbacks the program counted
(``speck_tpu_torch.utils.timings.READBACKS``, none where the program lacks
the counter), then the record as the last line of standard output
(``--out``: also to that file). Where every synchronize of a call is a
counted readback the two counts are equal. It checks no output against the
reference; ``run.py`` does.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import traceback
import warnings

from .manifest import Bench
from .run import card_line


def readbacks() -> dict:
    """The program's readbacks so far, ``{what: [copies, bytes]}``."""
    timings = importlib.import_module("speck_tpu_torch.utils.timings")
    return {k: list(v) for k, v in getattr(timings, "READBACKS", {}).items()}


def _sub(after: dict, before: dict) -> dict:
    """``after`` less ``before``, key by key, of [count, amount] lists."""
    out = {}
    for k, v in after.items():
        d = [x - y for x, y in zip(v, before.get(k, [0] * len(v)))]
        if d[0]:
            out[k] = d
    return out


def sync_calls(entry, i: int, cuda: bool) -> dict:
    """Call ``i`` of ``entry``: the readbacks the program counted and, on
    a card, the synchronizing operations torch reports under
    ``set_sync_debug_mode("warn")`` (``syncs`` None on a CPU). Torch
    reports one synchronize of its own at a process's first switch of the
    mode (outside any call), so the mode is switched once before."""
    import torch

    if not cuda:
        before = readbacks()
        entry.call(i)
        rb = _sub(readbacks(), before)
        return {"syncs": None, "sync_sites": {},
                "readbacks": sum(v[0] for v in rb.values()),
                "readback_kinds": rb}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    before = readbacks()
    where = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
                  for f in traceback.extract_stack()[:-1]
                  if "speck_tpu_torch" in f.filename]
        key = " < ".join(frames[::-1][:3]) or f"{filename}:{lineno}"
        where[key] = where.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            entry.call(i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    rb = _sub(readbacks(), before)
    return {"syncs": sum(where.values()), "sync_sites": where,
            "readbacks": sum(v[0] for v in rb.values()),
            "readback_kinds": rb}


def check(bench: Bench, cell: str, seed: int, device) -> dict:
    """The record of ``main``'s last line for ``cell`` on ``device``."""
    import torch

    from . import window

    cuda = torch.device(device).type == "cuda"
    wl = bench.workload(cell)
    cfg = bench.config(wl["config"])
    st = bench.generator(cfg["generator"]).structure(cfg, seed)
    entry = window.make(bench.traffic(wl["traffic"]), st, cfg, seed, device)
    entry.call(0)
    if cuda:
        torch.cuda.synchronize()
    out = sync_calls(entry, 1, cuda)
    entry.free()
    return {"cell": cell, "seed": seed,
            "card": card_line() if cuda else "cpu", **out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m speckbench.syncs",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("speckbench.syncs: needs a CUDA card", file=sys.stderr)
        return 2
    out = check(Bench.load(), args.workload, args.seed,
                torch.device("cuda", 0))
    print(f"# {args.workload}: {out['syncs']} syncs, {out['readbacks']} "
          f"readbacks {out['readback_kinds']}; sites {out['sync_sites']}",
          file=sys.stderr)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
