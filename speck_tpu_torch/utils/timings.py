"""The port's instrumentation: stage timers, profiler ranges, and the
host-device copies of a call.

- ``StageTimer``: one of the reference's stages (``STAGE_NAMES``). With a
  ``Timings`` that tracks it, the stage's host time is added to that
  ``Timings``, and a stage that ends in work on a CUDA device is closed by
  ``stop``'s ``torch.cuda.synchronize()``, so the host clock covers the
  device work. That is the only synchronize here.
- ``span``: the port's one profiler range. While ``torch.profiler`` is on
  it opens ``record_function(name)``; otherwise it does nothing. A range
  never synchronizes: the profiler ties each device operation to the host
  operation that launched it (its correlation id), and so to the ranges
  open on the host at the launch. Every ``StageTimer`` opens the range
  ``speck.<stage>``, whether or not it has a ``Timings``; the call path
  opens the sub-ranges that ``ops/spgemm.py``'s docstring lists.
- ``readback``: every explicit device-to-host copy of the single-device
  call path (``spgemm``, ``plan_spgemm``, ``SpgemmPlan.execute``), inside
  the range ``speck.readback.<what>`` and counted in ``READBACKS[what] =
  [copies, bytes]`` (on any device: a CPU tensor counts what the card's
  path would copy). On the card each is a synchronize.
- ``host_pass``: each O(nnz) pass over a host copy that planning makes,
  counted in ``HOST_NNZ_PASSES[what] = passes``.
- ``upload``: a host array onto the device without a synchronize (an
  asynchronous copy from pinned memory on a CUDA device), so that the
  readbacks are the call path's only synchronizing copies.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

STAGE_NAMES = (
    "countProducts",        # analysis pass
    "loadBalanceCounting",  # planning
    "spGEMMCounting",       # chunk count/stage + wide levels
    "allocC",               # offset scan + nnz readback
    "spGEMMNumeric",        # emission
    "complete",
)

# the call path's device-to-host copies in this process: {what: [copies,
# bytes]}
READBACKS: Dict[str, List[int]] = {}

# the O(nnz) host passes that planning makes in this process: {what:
# passes} (the gates past host_analysis_max_nnz read O(rows) otherwise)
HOST_NNZ_PASSES: Dict[str, int] = {}

_NO_RANGE = contextlib.nullcontext()


class Timings:
    """Accumulating stage->milliseconds map with += and /= semantics."""

    def __init__(self) -> None:
        self.ms: Dict[str, float] = {k: 0.0 for k in STAGE_NAMES}
        self.measure_all = False      # TrackIndividualTimes
        self.measure_complete = False  # TrackCompleteTimes

    def add(self, stage: str, ms: float) -> None:
        self.ms[stage] = self.ms.get(stage, 0.0) + ms

    def __iadd__(self, other: "Timings") -> "Timings":
        for k, v in other.ms.items():
            self.ms[k] = self.ms.get(k, 0.0) + v
        return self

    def __itruediv__(self, n: float) -> "Timings":
        for k in self.ms:
            self.ms[k] /= n
        return self

    def items(self) -> Iterator:
        return iter(self.ms.items())

    def report(self) -> str:
        return "\n".join(f"{k}: {v:.4f} ms" for k, v in self.ms.items()
                         if v != 0.0)


def span(name: str):
    """A profiler range named ``name`` while ``torch.profiler`` is on,
    else a context that does nothing."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_RANGE


def readback(t: torch.Tensor, what: str) -> np.ndarray:
    """``t`` copied to the host as numpy, counted in ``READBACKS[what]``,
    inside the range ``speck.readback.<what>``."""
    with span("speck.readback." + what):
        out = t.cpu().numpy()
    n = READBACKS.setdefault(what, [0, 0])
    n[0] += 1
    n[1] += t.numel() * t.element_size()
    return out


def host_pass(what: str) -> None:
    """Count one O(nnz) host pass of planning in ``HOST_NNZ_PASSES``."""
    HOST_NNZ_PASSES[what] = HOST_NNZ_PASSES.get(what, 0) + 1


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``. A CUDA device gets it by an
    asynchronous copy from pinned host memory, which the caching host
    allocator keeps until the copy has run: no synchronize."""
    if torch.device(device).type != "cuda":
        return torch.as_tensor(x, device=device)
    return torch.from_numpy(np.ascontiguousarray(x)).pin_memory().to(
        device, non_blocking=True)


def sync_tensors(*tensors) -> None:
    """Wait for the device work behind ``tensors`` (CUDA tensors only)."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


class StageTimer:
    """Context-manager stage timer inside the range ``speck.<stage>``;
    ``stop`` waits for the given tensors where a ``Timings`` tracks the
    stage."""

    def __init__(self, timings: Optional[Timings], stage: str,
                 enabled: bool = True):
        self.timings = timings
        self.stage = stage
        self.enabled = enabled and timings is not None
        self._t0 = 0.0
        self._range = _NO_RANGE

    def __enter__(self):
        self._range = span("speck." + self.stage)
        self._range.__enter__()
        if self.enabled:
            self._t0 = time.perf_counter()
        return self

    def stop(self, *block_on) -> None:
        if self.enabled:
            sync_tensors(*block_on)

    def __exit__(self, *exc):
        if self.enabled:
            self.timings.add(self.stage,
                             (time.perf_counter() - self._t0) * 1e3)
        self._range.__exit__(*exc)
        return False
