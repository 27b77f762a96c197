"""What one call of a cell does: the entries a traffic mix can name.

A traffic file (``speckbench/traffic/<mix>.json``) names its ``entry``
and the entry's parameters:

- ``"spgemm"``: every call is ``speck_tpu_torch.spgemm(A, A)`` on inputs
  put on the device once in set-up (value set 0).
- ``"plan_execute"``: set-up runs ``plan_spgemm(A, A)`` once on value set
  0 and draws ``value_sets`` more on A's structure (sets 1 to K); call i is
  ``plan.execute(A_k, A_k)`` with k = 1 + i mod K, so no call repeats the
  plan's values.

This is the one module of the benchmark that calls the program; the stage
spans it reads are the program's ``Timings``, recorded with their
intervals by ``SpanTimings``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch

import speck_tpu_torch
from speck_tpu_torch.formats.csr import HostCSR

from .inputs import Structure, draw_values, value_dtype


class SpanTimings(speck_tpu_torch.Timings):
    """The program's ``Timings`` with every stage kept as a (stage, start,
    end) span in ms of the host clock (a stage ends in a synchronize)."""

    def __init__(self) -> None:
        super().__init__()
        self.measure_all = True
        self.spans: List[Tuple[str, float, float]] = []

    def add(self, stage: str, ms: float) -> None:
        super().add(stage, ms)
        end = time.perf_counter() * 1e3
        self.spans.append((stage, end - ms, end))


class Square:
    """``spgemm(A, A)`` on the value set the inputs carry."""

    def __init__(self, st: Structure, cfg: dict, seed: int, params: dict,
                 device, dtype: Optional[torch.dtype] = None):
        self.dtype = dtype or value_dtype(cfg)
        self.st, self.cfg, self.seed, self.device = st, cfg, seed, device
        v0 = draw_values(st, cfg, seed, 0, device)
        host = HostCSR(rows=st.rows, cols=st.cols, row_offsets=st.indptr,
                       col_ids=st.indices, data=_host_values(v0))
        self.A = speck_tpu_torch.device_put_csr(host, self.dtype,
                                                device=device)

    def call(self, i: int, timings=None):
        return speck_tpu_torch.spgemm(self.A, self.A, timings=timings)

    def value_set(self, i: int) -> int:
        return 0

    def free(self) -> None:
        self.A = None


class Reuse(Square):
    """``plan.execute(A_k, A_k)`` of one plan over ``value_sets`` sets."""

    def __init__(self, st, cfg, seed, params, device, dtype=None):
        super().__init__(st, cfg, seed, params, device, dtype)
        self.plan = speck_tpu_torch.plan_spgemm(self.A, self.A)
        self.sets = [dataclasses.replace(
            self.A, data=draw_values(st, cfg, seed, k, device).to(self.dtype))
            for k in range(1, int(params["value_sets"]) + 1)]

    def call(self, i: int, timings=None):
        a = self.sets[i % len(self.sets)]
        return self.plan.execute(a, a, timings=timings)

    def value_set(self, i: int) -> int:
        return 1 + i % len(self.sets)

    def free(self) -> None:
        self.A = self.plan = self.sets = None


ENTRIES = {"spgemm": Square, "plan_execute": Reuse}


def make(traffic: dict, st: Structure, cfg: dict, seed: int, device,
         dtype: Optional[torch.dtype] = None):
    return ENTRIES[traffic["entry"]](st, cfg, seed, traffic, device, dtype)


def _host_values(v: torch.Tensor):
    """A value set as numpy (bfloat16, which numpy lacks, as float32)."""
    v = v.cpu()
    return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
