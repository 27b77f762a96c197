"""The readings that ``graph500_bf16``'s ``val_err`` limit is set from, and
the two controls that the limit must fail, at the cell's own size:

    python3 scripts/graph500_bf16_limits.py --seeds 101-103 \
        [--program-seconds 2] [--workload graph500.bf16] [--out FILE]

For each seed: the program's run (``speckbench.run.run``: inputs, set-up,
a window of ``--program-seconds``, the comparison of the kept call's output
with the reference; 0 skips it) and two controls on the seed's value set 1,
each held to ``speckbench.reference`` like the program's output:

- ``fp8_inputs``: the reference's product with its inputs rounded through
  ``torch.float8_e4m3fn``, a precision below the configuration's;
- ``bf16_sums``: the products (exact in float64) summed into each entry
  one after another in bfloat16, every partial sum rounded: the
  accumulation a port must not do.

One JSON line a seed, then a summary: the largest ``val_err`` of the
program and the smallest of each control, beside the configuration's
limit. Plain torch and numpy; imports neither jax nor the reference
package. Needs a CUDA card where the program runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Tuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from speckbench import reference  # noqa: E402
from speckbench.inputs import Structure  # noqa: E402

CSR = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fp8_inputs(st: Structure, v: torch.Tensor) -> CSR:
    """A @ A by the reference, A's values rounded through float8_e4m3fn:
    (offsets, columns, float64 values)."""
    low = v.float().to(torch.float8_e4m3fn).double()
    a = reference.Operand.of(st, low)
    c = reference.product(a, a)
    return torch.as_tensor(c.st.indptr), c.ix, c.v


def _sequential_bf16(seg: torch.Tensor, prod: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """Each segment's products (``seg`` non-decreasing) added one after
    another into a bfloat16 sum, in their order."""
    dev = prod.device
    new = torch.ones(seg.shape[0], dtype=torch.bool, device=dev)
    new[1:] = seg[1:] != seg[:-1]
    starts = torch.nonzero(new).flatten()
    pos = torch.arange(seg.shape[0], device=dev) - starts[seg]
    order = torch.sort(pos, stable=True).indices
    counts = torch.bincount(pos).tolist()
    acc = torch.zeros(n_out, dtype=torch.bfloat16, device=dev)
    off = 0
    for n in counts:
        idx = order[off:off + n]
        off += n
        s = seg[idx]
        acc[s] = (acc[s].double() + prod[idx]).to(torch.bfloat16)
    return acc


def bf16_sums(st: Structure, v: torch.Tensor,
              budget: int = reference.BLOCK_PRODUCTS) -> CSR:
    """A @ A with every entry's products (exact in float64) summed in
    bfloat16, in the order of A's row: (offsets, columns, bfloat16
    values)."""
    a = reference.Operand.of(st, v)
    dev = v.device
    cs = reference.product_counts(st, st)
    counts, cols, vals = [], [], []
    for r0, r1 in reference.row_blocks(st, cs, budget):
        s, t = int(st.indptr[r0]), int(st.indptr[r1])
        n_prod = int(cs[t] - cs[s])
        k = a.ix[s:t]
        blen = a.ip[k + 1] - a.ip[k]

        def rep(x):
            return torch.repeat_interleave(x, blen, output_size=n_prod)

        src = rep(torch.arange(s, t, device=dev))
        pos = (torch.arange(n_prod, device=dev) - rep(torch.cumsum(blen, 0)
                                                      - blen) + rep(a.ip[k]))
        key = (a.row[src] - r0) * st.cols + a.ix[pos]
        key, perm = torch.sort(key, stable=True)
        prod = (a.v[src].double() * a.v[pos].double())[perm]
        del src, pos, perm
        new = torch.ones(n_prod, dtype=torch.bool, device=dev)
        new[1:] = key[1:] != key[:-1]
        seg = torch.cumsum(new, 0) - 1
        n_out = int(seg[-1]) + 1 if n_prod else 0
        vals.append(_sequential_bf16(seg, prod, n_out))
        ukey = key[new]
        urow = torch.div(ukey, st.cols, rounding_mode="floor")
        counts.append(torch.bincount(urow, minlength=r1 - r0))
        cols.append(ukey - urow * st.cols)
    indptr = torch.zeros(st.rows + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(torch.cat(counts).cpu(), 0)
    return indptr, torch.cat(cols), torch.cat(vals)


CONTROLS = {"fp8_inputs": fp8_inputs, "bf16_sums": bf16_sums}


def held(st: Structure, v: torch.Tensor, c: CSR) -> dict:
    """``c`` against the reference of A @ A on A's own values:
    ``struct_rows`` and ``val_err``."""
    a = reference.Operand.of(st, v)
    return reference.compare(*c, (st.rows, st.cols), a, a)


def controls(st: Structure, v: torch.Tensor) -> dict:
    """Each control's ``struct_rows`` and ``val_err``."""
    return {name: held(st, v, fn(st, v)) for name, fn in CONTROLS.items()}


def main(argv=None) -> int:
    from speckbench.calibrate import seeds
    from speckbench.inputs import draw_values
    from speckbench.manifest import Bench
    from speckbench.run import card_line, run

    p = argparse.ArgumentParser(prog="graph500_bf16_limits")
    p.add_argument("--workload", default="graph500.bf16")
    p.add_argument("--seeds", default="101-103")
    p.add_argument("--program-seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = Bench.load()
    cfg = bench.config(bench.workload(args.workload)["config"])
    dev = torch.device("cuda", 0)
    rows = []
    for seed in seeds(args.seeds):
        row = {"cell": args.workload, "seed": seed}
        if args.program_seconds > 0:
            res = run(bench, args.workload, seed, args.program_seconds,
                      False, dev)
            row["program"] = {"correct": res["correct"],
                              "attempted": res["attempted"],
                              **{n: c["value"]
                                 for n, c in res["checks"].items()}}
            torch.cuda.empty_cache()
        st = bench.generator(cfg["generator"]).structure(cfg, seed)
        v = draw_values(st, cfg, seed, 1, dev)
        row.update(controls(st, v))
        del v
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
    summary = {"cell": args.workload, "card": card_line(),
               "limit": cfg["limits"]["val_err"]}
    for name in ("program", *CONTROLS):
        errs = [float(r[name]["val_err"]) for r in rows if name in r]
        if errs:
            summary[name] = {"largest" if name == "program" else "smallest":
                             (max if name == "program" else min)(errs),
                             "struct_rows": max(int(r[name]["struct_rows"])
                                                for r in rows if name in r)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
