"""Benchmark executor: load, validate, warm up, measure.

The port's form of ``speck_tpu/executor.py``: config keys
IterationsWarmUp, IterationsExecution, TrackIndividualTimes,
TrackCompleteTimes, CompareResult; an optional scipy oracle product; a
warmup loop, then a measured loop whose mean complete-call time is
reported with GFLOPS = 2 * products / time and nnz(C)/s. Each timed call
ends in ``torch.cuda.synchronize()`` on a CUDA device. The device is the
first CUDA card unless the caller passes ``device="cpu"`` (plain torch
versions of the kernels); without a card the default raises. Every
result names the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .formats.loader import DataLoader
from .ops.device_csr import device_get_csr, device_put_csr
from .ops.spgemm import spgemm
from .utils.compare import compare_csr
from .utils.config import Config, SpgemmConfig, spgemm_config_from_ini
from .utils.device import resolve_device
from .utils.oracle import oracle_spgemm
from .utils.timings import Timings, sync_tensors


@dataclasses.dataclass
class RunResult:
    device: str
    nnz: int
    mean_total_ms: float
    timings: Timings
    sum_products: float
    gflops: float
    nnz_per_s: float
    compared_ok: Optional[bool]


class Executor:
    def __init__(self, path: str, config: Optional[Config] = None,
                 spgemm_cfg: Optional[SpgemmConfig] = None,
                 dtype=torch.float32, device=None, verbose: bool = True):
        self.path = path
        self.config = config or Config.get()
        self.spgemm_cfg = spgemm_cfg or spgemm_config_from_ini(self.config)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.verbose = verbose

    def run(self) -> RunResult:
        cfg = self.config
        iterations_warmup = cfg.get_int("IterationsWarmUp", 10)
        iterations = cfg.get_int("IterationsExecution", 10)
        track_individual = cfg.get_bool("TrackIndividualTimes", False)
        track_complete = cfg.get_bool("TrackCompleteTimes", True)
        compare_result = cfg.get_bool("CompareResult", False)

        dl = DataLoader(self.path, dtype=np.float64, verbose=self.verbose)
        a, b = dl.cpuA, dl.cpuB
        if self.verbose:
            st = a.row_statistics()
            print(f"Matrix: {self.path}: {a.rows}x{a.cols}: {a.nnz} nonzeros"
                  f" (row mean {st['mean']:.2f}, max {st['max']})")
        A = device_put_csr(a, self.dtype, self.device)
        B = device_put_csr(b, self.dtype, self.device) if b is not a else A
        reference = oracle_spgemm(a, b) if compare_result else None
        compared_ok: Optional[bool] = None

        def one_iteration(timings: Timings):
            nonlocal compared_ok
            t0 = time.perf_counter()
            C = spgemm(A, B, self.spgemm_cfg, timings)
            sync_tensors(C.data)
            total_ms = (time.perf_counter() - t0) * 1e3
            if reference is not None:
                res = compare_csr(reference, device_get_csr(C))
                compared_ok = bool(res) and (compared_ok is not False)
                if not res and self.verbose:
                    print(f"COMPARE FAILED: {res.message}")
            return C, total_ms

        for _ in range(max(iterations_warmup, 1)):
            C, _ = one_iteration(Timings())

        timings = Timings()
        timings.measure_all = track_individual
        timings.measure_complete = track_complete
        total_ms_acc = 0.0
        n_iter = max(iterations, 1)
        for _ in range(n_iter):
            C, total_ms = one_iteration(timings)
            total_ms_acc += total_ms
        timings /= n_iter
        mean_total_ms = total_ms_acc / n_iter

        ip = np.asarray(a.row_offsets, np.int64)
        b_len = np.diff(np.asarray(b.row_offsets, np.int64))
        sum_products = float(b_len[np.asarray(a.col_ids, np.int64)].sum()) \
            if ip[-1] else 0.0
        gflops = (2.0 * sum_products / (mean_total_ms * 1e6)
                  if mean_total_ms else 0.0)
        nnz_per_s = C.nnz / (mean_total_ms * 1e-3) if mean_total_ms else 0.0
        dev_name = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "cpu")
        if self.verbose:
            print(f"spECK-torch  device: {dev_name}")
            print(f"             nnz: {C.nnz}, mean total time: "
                  f"{mean_total_ms:.3f} ms")
            print(f"             GFLOPS: {gflops:.2f}, nnz(C)/s: "
                  f"{nnz_per_s:.3e}")
            if track_individual:
                print(timings.report())
            if compared_ok is not None:
                print(f"compare vs oracle: "
                      f"{'OK' if compared_ok else 'FAILED'}")
        return RunResult(device=dev_name, nnz=C.nnz,
                         mean_total_ms=mean_total_ms, timings=timings,
                         sum_products=sum_products, gflops=gflops,
                         nnz_per_s=nnz_per_s, compared_ok=compared_ok)
