"""Per-stage wall timers (stage names as in ``speck_tpu``).

A stage that ends in work on a CUDA device is closed by
``torch.cuda.synchronize()``, so the host clock covers the device work.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional

import torch

STAGE_NAMES = (
    "init",
    "countProducts",        # analysis pass
    "loadBalanceCounting",  # planning
    "globalMapsCounting",
    "spGEMMCounting",       # chunk count/stage + wide levels
    "allocC",               # offset scan + nnz readback
    "loadBalanceNumeric",
    "globalMapsNumeric",
    "spGEMMNumeric",        # emission
    "sorting",
    "cleanup",
    "complete",
)


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


def sync_tensors(*tensors) -> None:
    """Wait for the device work behind ``tensors`` (CUDA tensors only)."""
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


class StageTimer:
    """Context-manager stage timer; ``stop`` waits for the given tensors."""

    def __init__(self, timings: Optional[Timings], stage: str,
                 enabled: bool = True):
        self.timings = timings
        self.stage = stage
        self.enabled = enabled and timings is not None
        self._t0 = 0.0

    def __enter__(self):
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
        return False
