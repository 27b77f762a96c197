"""The arithmetic that turns a run's records into metrics: the window's
statistics, the self time of nested stage spans, the device's busy time as
a union of intervals, and the reading of a ``torch.profiler`` trace into
device operations, busy time and idle gaps named by what the host was
doing. Imports nothing of the program.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def p90(times: Sequence[float]) -> float:
    """The 90th percentile (``statistics.quantiles``, exclusive method);
    the largest value below two samples."""
    if len(times) < 2:
        return max(times)
    return statistics.quantiles(times, n=10)[-1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The disjoint, sorted intervals that cover ``intervals``."""
    out: List[Interval] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def covered(intervals: Sequence[Interval]) -> float:
    """Length of the union of ``intervals``."""
    return sum(hi - lo for lo, hi in union(intervals))


def gaps(intervals: Sequence[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [g for g in out if g[1] > g[0]]


def self_times(spans: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Each stage's summed duration less the part of it that other spans
    inside it cover (``(stage, start, end)``; a span is inside another
    when it starts no earlier and ends no later)."""
    out: Dict[str, float] = {}
    for i, (name, lo, hi) in enumerate(spans):
        inner = [(a, b) for j, (_, a, b) in enumerate(spans)
                 if j != i and a >= lo and b <= hi and (a, b) != (lo, hi)]
        out[name] = out.get(name, 0.0) + (hi - lo) - covered(inner)
    return out


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's or op's name without its argument list."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:limit]


def read_profile(events, window_name: str):
    """From ``torch.profiler``'s events: (device operations as (name,
    start_us, end_us) inside the window, the window's (start_us, end_us),
    the host's top-level operations inside it as (name, start_us, end_us)).
    The window is the ``record_function`` span named ``window_name``; its
    mark on the device's timeline, and any other such mark, is no
    operation."""
    win = next(e for e in events
               if e.name == window_name and e.device_type.name == "CPU")
    lo, hi = win.time_range.start, win.time_range.end
    dev, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if end < lo or start > hi:
            continue
        if e.device_type.name == "CUDA":
            if e.name == window_name or getattr(e, "is_user_annotation",
                                                False):
                continue
            dev.append((e.name, max(start, lo), min(end, hi)))
        elif e.cpu_parent is win:
            host.append((e.name, start, end))
    return dev, (lo, hi), host


def breakdown(dev, window: Interval, host, top: int = 10) -> dict:
    """The device operations that took most time (summed by short name)
    and the longest idle gaps, each named by the host's top-level
    operations running when it began and when it ended, in seconds."""
    by_name: Dict[str, float] = {}
    for name, a, b in dev:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        return short_name(host[i][0], 60) if i >= 0 else "window start"

    idle = sorted(gaps([(a, b) for _, a, b in dev], *window),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in idle:
        first, last = at(a), at(b)
        named.append([first if first == last else f"{first} .. {last}",
                      (b - a) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def stage_mean(rec: dict, stages: Sequence[str]):
    """The summed self time of ``stages`` a call (ms), mean over the calls
    with spans; None where no call has one of them."""
    calls = rec["stages"]
    if not any(s in c for c in calls for s in stages):
        return None
    return sum(sum(c.get(s, 0.0) for s in stages) for c in calls) / len(calls)


def kernel_seconds(rec: dict, kernels: Sequence[str]) -> float:
    """Device seconds of the operations whose name holds one of
    ``kernels``, over the profiled window."""
    return sum(b - a for name, a, b in rec["device_ops"]
               if any(k in name for k in kernels)) / 1e6
