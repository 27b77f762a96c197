"""What one call of a cell does: the entries a traffic mix can name.

A traffic file (``speckbench/traffic/<mix>.json``) names its ``entry``
and the entry's parameters:

- ``"spgemm"``: every call is ``speck_tpu_torch.spgemm(A, A)`` on inputs
  put on the device once in set-up (value set 0): a ``"chain"`` of that
  one step.
- ``"plan_execute"``: set-up runs ``plan_spgemm(A, A)`` once on value set
  0 and draws ``value_sets`` more on A's structure (sets 1 to K); call i is
  ``plan.execute(A_k, A_k)`` with k = 1 + i mod K, so no call repeats the
  plan's values.
- ``"chain"``: every call runs the traffic's ``steps`` over its
  ``operands`` (``operands.py``), each step a call of the program's public
  ``speck_tpu_torch.spgemm`` or ``speck_tpu_torch.transpose``, on inputs
  put on the device once in set-up (A's value set 0); the last step's
  product is the call's output. Nothing of one call is kept for the next.

Each entry holds its ``inputs`` and the ``steps`` that its calls run, from
which the reference works out the same product again.

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
from .manifest import Bench
from .operands import Inputs, check_steps


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


SQUARE = (("C", "spgemm", "A", "A"),)


def _device_csr(st: Structure, v: torch.Tensor, dtype: torch.dtype,
                device):
    host = HostCSR(rows=st.rows, cols=st.cols, row_offsets=st.indptr,
                   col_ids=st.indices, data=_host_values(v))
    return speck_tpu_torch.device_put_csr(host, dtype, device=device)


class Chain:
    """The traffic's ``steps`` over its operands, A on value set 0; without
    ``steps``, ``spgemm(A, A)``."""

    def __init__(self, inputs: Inputs, params: dict, device,
                 dtype: Optional[torch.dtype] = None):
        self.inputs = inputs
        self.steps = tuple(tuple(s) for s in params.get("steps", SQUARE))
        self.dtype = dtype or value_dtype(inputs.cfg)
        named = inputs.named(0, device)
        check_steps(self.steps, named)
        self.ops = {name: _device_csr(st, v, self.dtype, device)
                    for name, (st, v) in named.items()}

    def call(self, i: int, timings=None):
        env = dict(self.ops)
        for name, op, *args in self.steps:
            ops = [env[x] for x in args]
            env[name] = (speck_tpu_torch.spgemm(*ops, timings=timings)
                         if op == "spgemm"
                         else speck_tpu_torch.transpose(*ops))
        return env[self.steps[-1][0]]

    def value_set(self, i: int) -> int:
        return 0

    def free(self) -> None:
        self.ops = None


class Reuse(Chain):
    """``plan.execute(A_k, A_k)`` of one plan over ``value_sets`` sets."""

    def __init__(self, inputs, params, device, dtype=None):
        super().__init__(inputs, params, device, dtype)
        A = self.ops["A"]
        self.plan = speck_tpu_torch.plan_spgemm(A, A)
        self.sets = [dataclasses.replace(
            A, data=draw_values(inputs.st, inputs.cfg, inputs.seed, k,
                                device).to(self.dtype))
            for k in range(1, int(params["value_sets"]) + 1)]

    def call(self, i: int, timings=None):
        a = self.sets[i % len(self.sets)]
        return self.plan.execute(a, a, timings=timings)

    def value_set(self, i: int) -> int:
        return 1 + i % len(self.sets)

    def free(self) -> None:
        self.ops = self.plan = self.sets = None


ENTRIES = {"spgemm": Chain, "plan_execute": Reuse, "chain": Chain}


def make(traffic: dict, st: Structure, cfg: dict, seed: int, device,
         dtype: Optional[torch.dtype] = None, bench: Optional[Bench] = None):
    """The traffic's entry; the operands that it names are found by their
    generators' names in ``bench`` (the benchmark's own files where
    None)."""
    inputs = Inputs(bench or Bench({}), traffic, st, cfg, seed)
    return ENTRIES[traffic["entry"]](inputs, traffic, device, dtype)


def _host_values(v: torch.Tensor):
    """A value set as numpy (bfloat16, which numpy lacks, as float32)."""
    v = v.cpu()
    return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
