"""The readings that the limits of ``correct`` are set from, at a cell's own
size, in one process:

    python3 -m speckbench.calibrate --workload <cell> --seeds 1-12 \
        --control-seeds 101-103 [--seconds 2]

Each seed is a whole run (``run.run``: inputs, set-up, a short window, the
comparison with the reference) of the program as the configuration states
it; each control seed is the same run with the program's own values one
precision below the configuration's (float32 for float64, bfloat16 for
float32). One JSON line a run with the numbers compared, then a summary:
the lower reading (the largest of the program's runs) and the upper one
(the smallest of the control's) of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from .manifest import Bench
from .run import card_line, run

LOWER = {"float64": "float32", "float32": "bfloat16"}


def seeds(text: str):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m speckbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control-seeds", default="101-103")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    from .inputs import DTYPES

    bench = Bench.load()
    cfg = bench.config(bench.workload(args.workload)["config"])
    low = DTYPES[LOWER[cfg["value_dtype"]]]
    dev = torch.device("cuda", 0)
    found = {"program": [], "control": []}
    for kind, dtype, span in (("program", None, args.seeds),
                              ("control", low, args.control_seeds)):
        for seed in seeds(span):
            res = run(bench, args.workload, seed, args.seconds, False, dev,
                      dtype)
            nums = {n: c["value"] for n, c in res["checks"].items()}
            found[kind].append(nums)
            print(json.dumps({"cell": args.workload, "kind": kind,
                              "seed": seed, "correct": res["correct"],
                              "attempted": res["attempted"], **nums}),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    summary = {"cell": args.workload, "card": card_line(),
               "control": str(low)}
    for n in found["program"][0]:
        lower = max(float(r[n]) for r in found["program"])
        upper = min(float(r[n]) for r in found["control"])
        summary[n] = {"lower": lower, "upper": upper}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
