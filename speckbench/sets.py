"""Sets of runs of one cell, each a fresh process of the benchmark's own
command, and the spread of each end-to-end metric:

    python3 -m speckbench.sets --workload <cell> --seeds 11-16 --sets 2 \
        [--trace 0] [--out FILE]

Every set runs the same seeds in the same order. Each run's result line
goes to ``--out`` (JSON lines, with the set and seed beside it); the
summary gives, for each metric, each set's median and spread (the
distance between the quartiles over the median, ``trace.spread``) and the
bound that five times the wider spread would set (at least 1%).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from .calibrate import seeds
from .manifest import REPO, Bench
from .trace import spread


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m speckbench.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--seconds", type=float)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = Bench.load()
    seconds = args.seconds or bench.m["run_seconds"]
    rows = []
    for k in range(args.sets):
        for seed in seeds(args.seeds):
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "speckbench", "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(seconds), "--trace", str(args.trace)],
                cwd=REPO, capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            row = {"set": k, "seed": seed, "rc": proc.returncode,
                   "wall_s": time.time() - t0,
                   "result": json.loads(lines[-1]) if proc.returncode == 0
                   and lines else None}
            if row["result"] is None:
                row["stderr"] = proc.stderr[-3000:]
            rows.append(row)
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(row) + "\n")
    ok = [r for r in rows if r["result"]]
    summary = {"cell": args.workload, "runs": len(rows), "ok": len(ok),
               "correct": sum(r["result"]["correct"] for r in ok)}
    names = ok[0]["result"]["metrics"] if ok else {}
    for name in names:
        per_set = []
        for k in range(args.sets):
            vals = [r["result"]["metrics"][name]["value"] for r in ok
                    if r["set"] == k and name in r["result"]["metrics"]]
            if len(vals) >= 2:
                per_set.append({"median": statistics.median(vals),
                                "spread": spread(vals), "values": vals})
        if per_set:
            widest = max(s["spread"] for s in per_set)
            summary[name] = {"sets": per_set,
                             "bound_5x": max(0.01, 5 * widest)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
