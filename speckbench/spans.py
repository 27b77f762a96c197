"""The program's ranges in a ``torch.profiler`` trace: which program step
each device operation of the profiled window belongs to, and which step
the host was in at each instant the device sat idle. Pure arithmetic on
the profiler's events; imports nothing of the program.

The program opens a ``record_function`` range named ``speck.<...>`` around
each stage and each step inside one (``speck_tpu_torch/utils/timings.py``
``span``) while a profiler is on. The ranges nest on the host thread that
runs the calls, so at each instant a path of ranges is open, from the
outermost to the innermost. A device operation belongs to the innermost
range open when the runtime call that launched it began (the CUDA runtime
call and the device operation share a correlation id); an idle instant
belongs to the
innermost range open at that instant, or to ``outside`` where none is.
Idle is also summed by stage: the innermost of the program's five stage
ranges on the path (``STAGES``), else the innermost range, else
``outside``.

``METRICS`` are the per-layer numbers these records give, each a function
of a run's record (``speckbench/run.py``'s ``rec`` with the keys
``spans``, ``readbacks`` and ``live`` beside its own, ``live`` holding
``{"k1": contract.LAUNCH_LIVE, "k2": bitonic.LAUNCH_LIVE}`` over the
profiled calls); each returns None
where its records are empty.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import gaps

PREFIX = "speck."
OUTSIDE = "outside"
STAGES = ("speck.countProducts", "speck.loadBalanceCounting",
          "speck.spGEMMCounting", "speck.allocC", "speck.spGEMMNumeric")

Range = Tuple[str, float, float]
Piece = Tuple[float, float, Tuple[str, ...]]


def read_events(events, window_name: str):
    """From ``torch.profiler``'s events: (the program's ranges inside the
    window as (name, start_us, end_us), the start of each CUDA runtime
    call (``cuda*``, ``cu*``) by its correlation id, the device operations
    inside the window as (name, start_us, end_us, correlation id), the
    window's (start_us, end_us)). Ranges and runtime calls are taken from
    the window's host thread; the ranges' own marks on the device's
    timeline are no operation."""
    win = next(e for e in events
               if e.name == window_name and e.device_type.name == "CPU")
    lo, hi = win.time_range.start, win.time_range.end
    ranges, dev = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if end < lo or start > hi:
            continue
        if e.device_type.name == "CUDA":
            if e.name == window_name or getattr(e, "is_user_annotation",
                                                False):
                continue
            dev.append((e.name, max(start, lo), min(end, hi), e.id))
        elif e.thread == win.thread and e.name.startswith(PREFIX):
            ranges.append((e.name, start, end))
    launched = {d[3] for d in dev}
    launch = {e.id: e.time_range.start for e in events
              if e.device_type.name == "CPU" and e.id in launched
              and e.name.startswith("cu") and e.thread == win.thread}
    return ranges, launch, dev, (lo, hi)


def timeline(ranges: Sequence[Range], lo: float, hi: float) -> List[Piece]:
    """[lo, hi] cut into pieces (start, end, path) on which the same
    ranges are open; path runs from the outermost range to the innermost.
    Ranges nest (as ranges on one thread do); a range that starts where
    another ends opens after it closes; one of no length holds nothing."""
    ranges = [r for r in ranges if r[2] > r[1]]
    bounds = sorted({lo, hi} | {t for _, a, b in ranges for t in (a, b)
                                if lo < t < hi})
    # at one instant: closes first, then opens (outer before inner)
    marks = sorted([(b, 0, -a, name) for name, a, b in ranges]
                   + [(a, 1, -b, name) for name, a, b in ranges])
    out, stack, i = [], [], 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        while i < len(marks) and marks[i][0] <= a:
            t, is_open, _, name = marks[i]
            if is_open:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            i += 1
        out.append((a, b, tuple(stack)))
    return out


def _stage(path: Tuple[str, ...]) -> str:
    for name in reversed(path):
        if name in STAGES:
            return name
    return path[-1] if path else OUTSIDE


def attribute(ranges: Sequence[Range], launch: Dict[int, float], dev,
              window: Tuple[float, float]) -> dict:
    """Device and idle seconds by program range: ``device_s`` (each
    device operation by the innermost range open at its launch,
    ``unlinked`` where its launch is not in the window), ``idle_s`` (each
    idle instant by the innermost range open then) and ``idle_stage_s``
    (the same by stage, module docstring)."""
    lo, hi = window
    pieces = timeline(ranges, lo, hi)
    starts = [p[0] for p in pieces]

    def path_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if 0 <= i and t <= pieces[i][1] else ()

    device: Dict[str, float] = {}
    for _, a, b, corr in dev:
        if corr in launch:
            path = path_at(launch[corr])
            key = path[-1] if path else OUTSIDE
        else:
            key = "unlinked"
        device[key] = device.get(key, 0.0) + (b - a) / 1e6
    idle: Dict[str, float] = {}
    idle_stage: Dict[str, float] = {}
    j = 0
    for ga, gb in gaps([(a, b) for _, a, b, _ in dev], lo, hi):
        while j < len(pieces) and pieces[j][1] <= ga:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < gb:
            a, b, path = pieces[k]
            s = (min(b, gb) - max(a, ga)) / 1e6
            if s > 0:
                inner = path[-1] if path else OUTSIDE
                idle[inner] = idle.get(inner, 0.0) + s
                st = _stage(path)
                idle_stage[st] = idle_stage.get(st, 0.0) + s
            k += 1
    return {"device_s": device, "idle_s": idle, "idle_stage_s": idle_stage}


def _stage_idle_ms(rec: dict, stages: Sequence[str]) -> Optional[float]:
    """The idle put down to ``stages`` (and the ranges inside them), ms a
    profiled call; None where no profiled call opened one of them."""
    sp = rec.get("spans")
    if not sp or not any(s in sp["stages_seen"] for s in stages):
        return None
    by = sp["idle_stage_s"]
    return 1e3 * sum(by.get(s, 0.0) for s in stages) / rec["profiled_calls"]


def plan_idle_ms(rec: dict) -> Optional[float]:
    return _stage_idle_ms(rec, ("speck.countProducts",
                                "speck.loadBalanceCounting"))


def count_idle_ms(rec: dict) -> Optional[float]:
    return _stage_idle_ms(rec, ("speck.spGEMMCounting", "speck.allocC"))


def numeric_idle_ms(rec: dict) -> Optional[float]:
    return _stage_idle_ms(rec, ("speck.spGEMMNumeric",))


def readbacks_per_call(rec: dict) -> Optional[float]:
    """The call path's readbacks a profiled call; None without the
    program's counter."""
    rb = rec.get("readbacks")
    if rb is None:
        return None
    return sum(n for n, _ in rb.values()) / rec["profiled_calls"]


def _live_share(kinds: Sequence[dict]) -> Optional[float]:
    """Live over launched slots (%) of the launches that carry a live
    count (``{(R, W, ...): [launches, live slots]}``)."""
    live = sum(n[1] for k in kinds for n in k.values())
    slots = sum(n[0] * s[0] * s[1] for k in kinds for s, n in k.items())
    return 100.0 * live / slots if slots else None


def k2_live_share(rec: dict) -> Optional[float]:
    lv = rec.get("live")
    return _live_share([lv["k2"]]) if lv else None


def k1_live_share(rec: dict) -> Optional[float]:
    lv = rec.get("live")
    return _live_share([lv["k1"]]) if lv else None


METRICS = {"plan.idle_ms": plan_idle_ms, "count.idle_ms": count_idle_ms,
           "numeric.idle_ms": numeric_idle_ms,
           "host.readbacks": readbacks_per_call,
           "k2.live_share": k2_live_share, "k1.live_share": k1_live_share}


def record(events, window_name: str) -> dict:
    """``rec["spans"]``: ``attribute``'s sums over the window, and the
    stage ranges the window holds (``stages_seen``)."""
    ranges, launch, dev, window = read_events(events, window_name)
    out = attribute(ranges, launch, dev, window)
    out["stages_seen"] = sorted({n for n, _, _ in ranges if n in STAGES})
    return out
