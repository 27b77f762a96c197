"""Timing helpers of the probes: CUDA-event medians, the host clock of a
stage (``host_ms``), a profiled call, the synchronizing calls of a call
by the port's line that makes them (``sync_sites``) and the card's
line."""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, List

import torch


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` calls of fn's device time (CUDA events), after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_turns(fns: Dict[str, Callable], reps: int = 5
                  ) -> Dict[str, List[float]]:
    """Device times (CUDA events, ms) of the functions in ``fns`` taken in
    turns: one warm-up call each, then ``reps`` rounds that time each
    function once, in the given order on even rounds and reversed on odd
    ones, so that a drift of the card's clocks falls on all alike."""
    for fn in fns.values():
        fn()
    names = list(fns)
    times: Dict[str, List[float]] = {n: [] for n in names}
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return times


def _sync_card() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def host_ms(fn, reps: int = 5):
    """(median ms, min ms, the last call's output) of the host clock around
    ``reps`` calls of fn after one warm call, each call ending in
    ``torch.cuda.synchronize()`` when a card is in use. Planning stages are
    host work, which CUDA events would not see; the synchronize puts the
    device work a stage queued inside its time."""
    out = fn()
    _sync_card()
    times = []
    for _ in range(reps):
        _sync_card()
        t0 = time.perf_counter()
        out = fn()
        _sync_card()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), out


def sync_sites(fn):
    """Synchronizing calls (readbacks and pageable copies) in one call of
    fn, as torch.cuda's sync debug mode reports them, by where the port
    makes them: {"file:line (function)" of the innermost frame in
    speck_tpu_torch: count}."""
    import collections
    import traceback
    import warnings

    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        where = "outside the port"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if "speck_tpu_torch" in fr.filename:
                where = (f"{fr.filename.split('speck_tpu_torch/')[-1]}:"
                         f"{fr.lineno} ({fr.name})")
                break
        sites[where] += 1

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sites


def device_us(evt) -> float:
    """A profiler event's device time in microseconds."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_call(fn):
    """One call of fn under ``torch.profiler``, ending in a synchronize:
    (host ms, device ms summed over the kernels, the kernels' events by
    device time, longest first)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=device_us, reverse=True)
    return host_ms, sum(device_us(e) for e in kernels) / 1e3, kernels


def report(name: str, ms: float, n: int, nbytes: int, smi: str) -> None:
    """One line: time, elements per second and useful bytes per second."""
    print(f"{name}: {ms:.4f} ms, {n / ms / 1e3:.0f} M elem/s, "
          f"{nbytes / ms / 1e6:.1f} GB/s [{smi}]", flush=True)
