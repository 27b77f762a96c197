"""One run of one cell:

    python3 -m speckbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A fresh process makes the cell's inputs from the seed, puts them on the
card, runs the traffic's set-up and warm calls (``setup_s`` is the
process's age at the first timed call), then calls the entry back to back
for ``--seconds`` (a closed loop with one caller; every call ends in a
synchronize). One call of the window, drawn from the seed, keeps its
output; after the window the program's state is freed and that output is
held to the plain reference of the entry's steps over the same inputs
(``reference.check``) against the configuration's limits.

``--trace 0`` reports the cell's end-to-end metrics. ``--trace 1`` runs
calls with the program's stage spans (``window.SpanTimings``) for half of
``--seconds``, then calls under ``torch.profiler`` for a few seconds
(kernel time, busy and idle, the kernels' launches), and reports the
per-layer metrics that ``metrics/<name>.py`` read from those records.

The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key. Without a CUDA card (or with fewer than the cell asks for), or
with jax, jaxlib, flax or speck_tpu loaded once the window has closed, the
run prints no result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

from . import trace as tr
from .inputs import seed_of
from .manifest import Bench

FORBIDDEN = ("jax", "jaxlib", "flax", "speck_tpu")
WINDOW = "speckbench.window"
GIB = float(1 << 30)
# the traced run: the share of --seconds that calls with the program's
# stage spans take, then the seconds of calls under the profiler (reading
# its trace takes some ten times as long again)
SPAN_SHARE = 0.5
PROFILE_SECONDS = 4.0


def process_age() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as fh:
        up = float(fh.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Reservoir:
    """One call's output, drawn uniformly from the calls offered, with a
    generator seeded from the run's seed."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed_of(seed, 2))
        self.n = 0
        self.kept = None

    def offer(self, k: int, out) -> None:
        self.n += 1
        if self.rng.random() * self.n < 1.0:
            self.kept = (k, out)


class Loop:
    """The closed loop: the entry's calls, timed one by one on the host
    clock, each ending in a synchronize."""

    def __init__(self, entry, sync, res: Reservoir):
        self.entry, self.sync, self.res = entry, sync, res
        self.i = 0
        self.failed = 0
        self.stage_ms = []

    def call(self, timings=None) -> float:
        t0 = time.perf_counter()
        out = self.entry.call(self.i, timings)
        self.sync()
        dt = time.perf_counter() - t0
        self.res.offer(self.entry.value_set(self.i), out)
        self.i += 1
        return dt

    def run(self, seconds: float, n_min: int = 1, spans=None):
        """Calls until ``seconds`` have passed and ``n_min`` calls are made:
        (call times, the window's wall time from the first call's start to
        the last one's end)."""
        times = []
        t0 = time.perf_counter()
        while True:
            timings = spans() if spans else None
            try:
                times.append(self.call(timings))
            except Exception:
                traceback.print_exc()
                self.failed += 1
                break
            if timings is not None:
                self.stage_ms.append(tr.self_times(timings.spans))
            if (len(times) >= n_min
                    and time.perf_counter() - t0 >= seconds):
                break
        return times, time.perf_counter() - t0


def _launches():
    from speck_tpu_torch.ops import bitonic, contract

    return {"k1": dict(contract.LAUNCH_SHAPES),
            "k3": dict(contract.RUNS_LAUNCH_SHAPES),
            "k2": dict(bitonic.LAUNCH_SHAPES)}


def _diff(after: dict, before: dict) -> dict:
    return {kind: {s: c - before[kind].get(s, 0) for s, c in shapes.items()
                   if c > before[kind].get(s, 0)}
            for kind, shapes in after.items()}


def traced(loop: Loop, seconds: float, cuda: bool):
    """The two phases of a traced run: (the record the metrics' readers
    take, the breakdown); (None, None) once a call has failed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .window import SpanTimings

    loop.run(seconds * SPAN_SHARE, spans=SpanTimings)
    if loop.failed:
        return None, None
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        loop.call()  # the profiler's own start-up stays outside the window
        before = _launches()
        with record_function(WINDOW):
            profiled, _ = loop.run(min(PROFILE_SECONDS, seconds), n_min=2)
        launches = _diff(_launches(), before)
    if loop.failed:
        return None, None
    dev, window, host = tr.read_profile(prof.events(), WINDOW)
    window_s = (window[1] - window[0]) / 1e6
    rec = {"stages": loop.stage_ms, "launches": launches, "device_ops": dev,
           "busy_s": tr.covered([(a, b) for _, a, b in dev]) / 1e6,
           "window_s": window_s, "profiled_calls": len(profiled)}
    print(f"# traced: {len(loop.stage_ms)} calls with spans; "
          f"{len(profiled)} profiled, mean "
          f"{1e3 * statistics.mean(profiled)!r} ms, device busy "
          f"{rec['busy_s']!r} of {window_s!r} s", file=sys.stderr)
    return rec, (tr.breakdown(dev, window, host) if dev else None)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: no reading"


def run(bench: Bench, cell: str, seed: int, seconds: float, trace: bool,
        device, dtype=None) -> dict:
    """One run of ``cell`` on ``device``; ``dtype`` puts the program's
    values in another type than the configuration's (the control)."""
    import torch

    from . import reference, window

    wl = bench.workload(cell)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    st = bench.generator(cfg["generator"]).structure(cfg, seed)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    entry = window.make(traffic, st, cfg, seed, device, dtype, bench)
    entry.call(0)  # the warm call: every shape of the window built once
    sync()
    res = Reservoir(seed)
    loop = Loop(entry, sync, res)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age()
    metrics, bd, rec = {}, None, None
    if trace:
        rec, bd = traced(loop, seconds, cuda)
        for m in bench.per_layer(cell) if rec else ():
            v = bench.reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        times, wall = loop.run(seconds)
        e2e = {"setup_s": setup_s}
        if times:  # else the first call failed
            print(f"# window: {len(times)} calls in {wall!r} s; first "
                  f"{[round(t * 1e3, 3) for t in times[:3]]} ms, median "
                  f"{1e3 * statistics.median(times)!r} ms", file=sys.stderr)
            e2e.update(call_ms=1e3 * wall / len(times),
                       call_p90_ms=1e3 * tr.p90(times))
            if cuda:
                e2e["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
        for m in bench.end_to_end(cell):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    peak = max(setup_peak, torch.cuda.max_memory_allocated() if cuda else 0)
    print(f"# setup {setup_s!r} s; card {card_line() if cuda else 'cpu'}",
          file=sys.stderr)

    kept = res.kept
    attempted, failed = loop.i, loop.failed
    inputs, steps = entry.inputs, entry.steps
    entry.free()
    del entry, loop, res
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = cfg["limits"]
    t_check = time.perf_counter()
    if kept is None:
        found = {"struct_rows": st.rows, "val_err": math.inf}
    else:
        k, out = kept
        ops = {name: reference.Operand.of(s, v)
               for name, (s, v) in inputs.named(k, device).items()}
        found = reference.check(out.indptr, out.indices, out.data,
                                out.shape, ops, steps)
        del ops, out, kept
    print(f"# check {time.perf_counter() - t_check!r} s", file=sys.stderr)
    checks = {n: {"value": _finite(found[n]), "limit": limit}
              for n, limit in limits.items()}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1 if cuda else 0, "memory_peak_bytes": int(peak)}
    if rec is not None and cuda:
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = rec["window_s"]
    result = {"correct": bool(failed == 0 and all(
                  found[n] <= limits[n] for n in limits)),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if bd is not None:
        result["breakdown"] = bd
    result["checks"] = checks
    return result


def _finite(x):
    """A JSON-safe number: inf and NaN as strings."""
    return x if math.isfinite(x) else str(x)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m speckbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    bench = Bench.load()
    chips = int(bench.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"speckbench: the cell needs {chips} CUDA card(s), this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"speckbench: loaded once the window closed: {found}",
              file=sys.stderr)
        return 3
    report(result)
    return 0
