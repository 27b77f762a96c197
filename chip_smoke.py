#!/usr/bin/env python3
"""Smoke check of speck_tpu_torch on one CUDA card: build the kernels,
hold each against its plain torch version, then drive the product-stream
SpGEMM once at bench config 3's size and check it against scipy.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):
  1. a CUDA card must be present; print its name and power limit;
  2. build the kernels from csrc/ with nvcc (sm_90a), print the seconds;
  3. each kernel against its plain version at the main path's shapes
     (K1 stream_contract at (512, 8192) and (4, 65536) with a per-row rid;
     K2 row_sort at (512, 8192) with 1 and 3 payloads and at (2, 2^20)):
     masks and keys equal, (key, payload) pairs equal as per-row
     multisets, sums within atol 1e-6 + rtol 1e-5 of the run prefix's sum
     of magnitudes (fp32 sums in another order); times from CUDA events,
     median of 5, kernel beside plain;
  4. spgemm on make_powerlaw(262144, seed=7), A·A, f32, default
     SpgemmConfig: launch counts of both kernels from that run must be
     > 0 and the plan must have wide rows; result against the oracle
     (structure exact, values rel_tol 2e-3); cold call, median of 3 warm
     calls, GFLOPS = 2 * products / time;
  5. plan.execute(A2, A2) with new values on the same structure (the
     two-phase numeric path) against the oracle.
The last lines are the kernels' JSON line, the card's nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps=5):
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


def pair_multiset(key, pay):
    """Per row, the sorted (key, payload) pairs as int64."""
    x = (key.long() << 32) | (pay.view(torch.int32).long() & 0xffffffff)
    return torch.sort(x, dim=1).values


def contract_case(gen, R, W, const_rid, n_cols=4096):
    from speck_tpu_torch.ops import contract

    dev = torch.device("cuda")
    key = torch.sort(torch.randint(0, 1 << 22, (R, W), generator=gen,
                                   device=dev, dtype=torch.int32), 1).values
    if const_rid:
        col = torch.sort(torch.randint(0, n_cols, (R, W), generator=gen,
                                       device=dev, dtype=torch.int32),
                         1).values
        rid = (torch.arange(R, dtype=torch.int32, device=dev) + 5)[:, None]
        rid = rid.expand(R, W)
    else:
        rid, col = key >> 12, key & (n_cols - 1)
    dead = torch.arange(W, device=dev)[None, :] >= W - W // 8
    col = torch.where(dead, n_cols, col).to(torch.int32).contiguous()
    if not const_rid:
        rid = torch.where(dead, rid[:, :1], rid).to(torch.int32).contiguous()
    val = torch.randn((R, W), generator=gen, device=dev)
    last_k, sum_k = contract.stream_contract(rid, col, val, n_cols)
    last_p, sum_p = contract.contract_plain(rid, col, val, n_cols)
    torch.cuda.synchronize()
    check(torch.equal(last_k, last_p), f"K1 mask differs at {(R, W)}")
    # fp32 summation error scales with the sum of magnitudes over the run
    # prefix: rtol 1e-5 against that, atol 1e-6
    mag = contract.contract_plain(rid, col, val.abs(), n_cols)[1]
    err = (sum_k - sum_p).abs()
    check(bool((err <= 1e-6 + 1e-5 * mag).all()),
          f"K1 sums differ at {(R, W)}: max abs {float(err.max())}")
    ms = cuda_ms(lambda: contract.stream_contract(rid, col, val, n_cols))
    plain_ms = cuda_ms(lambda: contract.contract_plain(rid, col, val, n_cols))
    return float(err.max()), ms, plain_ms


def sort_case(gen, R, W, n_pay):
    from speck_tpu_torch.ops import bitonic

    dev = torch.device("cuda")
    key = torch.randint(0, 1 << 24, (R, W), generator=gen, device=dev,
                        dtype=torch.int32)
    key[:, : W // 8] = 2 ** 31 - 1
    pays = [torch.randint(-(1 << 30), 1 << 30, (R, W), generator=gen,
                          device=dev, dtype=torch.int32)
            for _ in range(n_pay - 1)]
    pays.append(torch.randn((R, W), generator=gen, device=dev))
    key_k, pay_k = bitonic.row_sort(key, pays)
    key_p, pay_p = bitonic.sort_plain(key, pays)
    torch.cuda.synchronize()
    check(torch.equal(key_k, key_p), f"K2 keys differ at {(R, W, n_pay)}")
    for a, b in zip(pay_k, pay_p):
        check(torch.equal(pair_multiset(key_k, a), pair_multiset(key_p, b)),
              f"K2 (key, payload) pairs differ at {(R, W, n_pay)}")
    ms = cuda_ms(lambda: bitonic.row_sort(key, pays))
    plain_ms = cuda_ms(lambda: bitonic.sort_plain(key, pays))
    return 0.0, ms, plain_ms


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA card")
    import speck_tpu_torch as pt
    from speck_tpu_torch.ops import bitonic, build, contract
    from speck_tpu_torch.utils.generators import make_powerlaw

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}",
          flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1 = {}
    for R, W, const in [(512, 8192, False), (4, 65536, True)]:
        k1[(R, W)] = contract_case(gen, R, W, const)
        err, ms, pms = k1[(R, W)]
        rid_kind = "row" if const else "plane"
        print(f"K1 stream_contract ({R}, {W}) rid={rid_kind}: "
              f"max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms [{smi}]", flush=True)
    k2 = {}
    for R, W, n_pay in [(512, 8192, 1), (512, 8192, 3), (2, 1 << 20, 1)]:
        k2[(R, W, n_pay)] = sort_case(gen, R, W, n_pay)
        _, ms, pms = k2[(R, W, n_pay)]
        print(f"K2 row_sort ({R}, {W}) payloads={n_pay}: kernel {ms:.4f} ms,"
              f" plain {pms:.4f} ms [{smi}]", flush=True)

    # 4. the main path at bench config 3's size
    t0 = time.perf_counter()
    h = make_powerlaw(262144, seed=7)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = pt.oracle_spgemm(h, h)
    t_ref = time.perf_counter() - t0
    cfg = pt.SpgemmConfig()
    A = pt.device_put_csr(h, torch.float32, "cuda")
    torch.cuda.synchronize()
    contract.LAUNCHES = 0
    bitonic.LAUNCHES = 0
    t0 = time.perf_counter()
    plan = pt.plan_spgemm(A, A, cfg)
    C = plan.execute()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = {"stream_contract": contract.LAUNCHES,
                "row_sort": bitonic.LAUNCHES}
    lo = plan.stream.layout
    print(f"config 3: m={h.rows} nnz(A)={h.nnz} generated in {t_gen:.2f} s, "
          f"oracle {t_ref:.2f} s; layout W={lo.W} G={lo.G} "
          f"chunks={lo.n_chunks} total_q={lo.total_q} n_wide={lo.n_wide} "
          f"r_wide={lo.r_wide} fused={plan.stream.fused} "
          f"finish_classes={len(plan.stream.finish['classes'] or [])} "
          f"ladder_levels={plan.stream.finish['ladder_levels']}; "
          f"launches {launches}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    check(lo.n_wide > 0, "config 3 planned no wide rows")
    Ch = pt.device_get_csr(C)
    r = pt.compare_csr(ref, Ch)
    check(r.ok, f"structure differs from the oracle: {r.message}")
    r = pt.compare_csr(ref, Ch, compare_data=True, rel_tol=2e-3)
    check(r.ok, f"values differ from the oracle: {r.message}")
    check(bool(np.isfinite(Ch.data).all()), "non-finite values in C")

    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Cw = pt.spgemm(A, A, cfg)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    warm_ms = statistics.median(warm)
    check(Cw.nnz == C.nnz, "warm call nnz differs from the cold call")
    products = float(plan.sum_products)
    print(f"config 3 A*A f32 [{smi}]: nnz(C)={C.nnz} products={products:.0f}"
          f" cold {cold_ms:.1f} ms, warm median of 3 {warm_ms:.1f} ms "
          f"(all {[round(w, 1) for w in warm]}), "
          f"GFLOPS {2 * products / (warm_ms * 1e6):.3f}, "
          f"nnz(C)/s {C.nnz / (warm_ms * 1e-3):.4g}", flush=True)

    # synchronizing calls in one warm call (readbacks and pageable copies)
    torch.cuda.set_sync_debug_mode("warn")
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pt.spgemm(A, A, cfg)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    print(f"synchronizing calls in one spgemm: {len(caught)}", flush=True)

    # 5. plan reuse with new values (two-phase numeric path)
    h2 = pt.HostCSR.from_parts(h.rows, h.cols, h.row_offsets, h.col_ids,
                               h.data * 2.0 + 0.25)
    A2 = pt.device_put_csr(h2, torch.float32, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C2 = plan.execute(A2, A2)
    torch.cuda.synchronize()
    reuse_ms = (time.perf_counter() - t0) * 1e3
    r = pt.compare_csr(pt.oracle_spgemm(h2, h2), pt.device_get_csr(C2),
                       compare_data=True, rel_tol=2e-3)
    check(r.ok, f"plan reuse differs from the oracle: {r.message}")
    print(f"plan.execute(A2, A2): {reuse_ms:.1f} ms, matches the oracle",
          flush=True)

    kernels = [
        {"name": "stream_contract", "route": "cuda",
         "source": "speck_tpu_torch/csrc/stream_contract.cu",
         "replaces": "speck_tpu/ops/pallas_kernels.py:122",
         "launches": launches["stream_contract"],
         "max_abs_err": max(v[0] for v in k1.values()),
         "ms": k1[(512, 8192)][1], "plain_ms": k1[(512, 8192)][2]},
        {"name": "row_sort", "route": "cuda",
         "source": "speck_tpu_torch/csrc/row_sort.cu",
         "replaces": "speck_tpu/ops/bitonic.py:172",
         "launches": launches["row_sort"],
         "max_abs_err": max(v[0] for v in k2.values()),
         "ms": k2[(512, 8192, 1)][1], "plain_ms": k2[(512, 8192, 1)][2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
