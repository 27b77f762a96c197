#!/usr/bin/env python3
"""Smoke check of speck_tpu_torch on one CUDA card: build the kernels,
hold each against its plain torch version, then drive the product-stream
SpGEMM once at bench config 3's size and on the bench's giant row, the
fixed-cap ESC (esc_fixed) at bench config 1's size, the diagonal-plane
routes of spgemm on bench configs 1, 1b, the 27-point stencil and the fp64
banded config, the general stream (a 2^20-row graph with the two-key
chunk sort, float64, row blocks, the dense-tile gate counted on the
device), the dense tiles, the accumulator, config 4 with the device
transpose and the Galerkin product, the row mesh in one process and
multihost_spgemm across worker processes (gloo on one card, NCCL with a
card a process where there are cards), the gather probes, the benchmark
harness (speck_tpu_torch.bench: its headline cell and config 3's stage
split) and the nine stage probes, and check each against its reference.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):
  1. a CUDA card must be present; print its name and power limit;
  2. build the kernels from csrc/ with nvcc (sm_90a), print the seconds;
  3. each kernel against its plain version at the main path's shapes
     (K1 stream_contract at (512, 8192) with a rid plane, in float32 and
     in double, and at (4, 65536) with a per-row rid; K2 row_sort at
     (512, 8192) with 1 and 3 payloads and at (2, 2^20)): masks equal,
     K2's keys and payloads equal to the stable plain sort's bit for bit,
     K1's sums within atol 1e-6 + rtol 1e-5 (float32) or rtol 1e-12
     (double) of the run prefix's sum of magnitudes (sums in another
     order) and two K1 launches bit-identical; K4 stream_expand at
     (512, 8192) on the middle chunk of planned streams
     (probes/expand_profile.py: config 3's graph A·A in float32, packed,
     and in bfloat16, a 60^3 27-point stencil's A·A in float64, each on
     the stream route): rid, col and val equal to expand_plain's bit for
     bit, two launches bit-identical; times from
     CUDA events around one call, medians of 5 in turns (K1 and its plain
     version; K2, its plain version and torch.sort + gather; K4 and its
     plain version);
  4. spgemm on make_powerlaw(262144, seed=7), A·A, f32, default
     SpgemmConfig: launch counts of both kernels from that run must be
     > 0 and the plan must have wide rows; K1's launches by (R, W, rid)
     and K2's by (R, W, payloads); K4's, read after plan_spgemm and again
     after execute, one a chunk of the stream in each pass that expands
     (check_expand, as in the stream cells of 7d and 7h); result against
     the oracle (structure exact, values rel_tol 2e-3); cold call, median
     of 3 warm calls, GFLOPS = 2 * products / time;
  5. plan.execute(A2, A2) with new values on the same structure (the
     two-phase numeric path) against the oracle;
  4b. (after 5) spgemm on the bench's giant row (make_giant_row(): 40,000
     rows, 50,084,873 nonzeros, 5 * 10^7 products in row 0), A·A, f32,
     default SpgemmConfig: launch counts > 0, the plan must have wide rows
     and a finish class; K1's and K2's launches by shape; result against
     the oracle (structure exact, values rel_tol 2e-3); cold call, median
     of 3 warm calls, GFLOPS;
  6. K3 contract_runs against its plain version at (65536, 2048)
     (esc_fixed's rectangle on config 1) in float32 and double and at
     (64, 256) (the entry's), two launches bit-identical, and K2 at
     esc_fixed's sort shapes, checked and timed as in phase 3;
  7. esc_fixed on make_banded(65536, 16, seed=3) (bench config 1), A·A,
     f32, cap = 2048 by the fixed-cap rule: launch counts of K3 and K2 in
     that call > 0, K2's launches by shape; result against the oracle
     (structure exact, values rel_tol 2e-3); cold call, median of 3 warm
     calls, GFLOPS, peak device memory; then entry()'s fn once against
     the oracle;
  7c. (after 7, before 7b) spgemm, default SpgemmConfig, on the
     diagonal-plane cells (DIA_CELLS): config 1 (make_banded(65536, 16,
     seed=3), f32: DIA, uniform emit, no K1 or K2 launch; then
     plan.execute(A2, A2) with new values, and its warm time beside
     esc_fixed's), stencil27 (make_stencil27(102), f32:
     sparse DIA through the lite gate), fp64 (make_banded(16384, 8,
     seed=9), float64: DIA, float64 values out), config 1b (make_mixed(),
     f32: the per-row DIA split beside stream rows, K1 and K2 launched).
     Each against the full oracle (structure exact, values rel_tol 2e-3,
     fp64 1e-9); the cold call, the median of 3 warm calls, GFLOPS,
     nnz(C)/s, peak memory, synchronizing calls in one warm call;
  7d. (after 7c, before 7b) the general-stream cells (GENERAL_CELLS),
     each through spgemm against the oracle (structure exact, values
     rel_tol 2e-3 in float32, 1e-9 in float64 with float64 values out):
     K4 one launch a chunk a pass in each unblocked cell (check_expand):
     the 2^20-row graph (make_powerlaw(1 << 20, seed=11), f32:
     pack_bits == 0 and wide rows), config 3 in float64 (the stream, K1
     in double only), config 1b in float64 (the per-row split with stream
     rows), config 3 under block_products = 2^24 (plan_spgemm raises
     ProductOverflow; at least 4 row blocks, printed; C's structure equal
     to the unblocked call's), config 3 under host_analysis=False (the
     stream, n_elig == 0 counted on the device and printed, nnz(C) equal
     to the default call's); then esc_fixed on config 1 in float64 (K3 in
     double). Each cell: the cold call, the median of 3 warm calls,
     GFLOPS, nnz(C)/s, peak memory, synchronizing calls, and K1's, K2's
     and K3's launches by shape and dtype;
  7e. (after 7d, before 7b) the routes of the dense tiles, the accumulator
     and the transpose (SLICE_CELLS, then galerkin_cell), each against the
     oracle (structure exact, values rel_tol 2e-3): config 1 under
     enable_dia=False (pure dense tiles: full_cover, no stream rows, the
     gather emit, K2 and no K1), config 1b under enable_dia=False (dense
     tiles beside stream rows: the scatter emit, K1 and K2), the bench's
     giant row under enable_accum=True (the accumulator; its warm time
     beside phase 4b's default call), config 4 (A = config 1, P =
     make_prolongation(65536, 16384): A·P streams every row, transpose(P)
     equal to scipy's P.T exactly, one K2 launch at (1, 65536, 2), then
     Pᵀ·(A·P)). Each: the cold call, the median of 3 warm calls, GFLOPS,
     nnz(C)/s, peak memory, synchronizing calls, K1's and K2's launches by
     shape;
  7f. (after 7e, before 7b) the row-sharded stream mesh, four shards on
     one card (parallel.make_row_mesh(4, devices=["cuda:0"]); the shards
     run one after another, so a mesh time is the sum of theirs and no
     copy crosses a link): mesh_stream_spgemm on config 3 (needset, then
     allgather, then float64 under needset; beside them phase 4's
     single-device warm call), on the giant row (needset: the k-split
     must engage with row 0 among the split rows) and on scipy's
     block_diag of four make_powerlaw(65536, seed=7) (needset: zero bytes
     exchanged, equal row ranges), on config 1, stencil27 (27, 27 and 125
     planes) and the fp64 band (the diagonal-plane route: mode dia_halo,
     no kernel), on config 1 under allgather with enable_sdia=False (the
     dense route: K2 alone) and on config 3 under needset_overlap (K1 and
     K2; its bytes equal to the needset cell's); mesh_spgemm_fixed_cap on
     config 1 (K2 and K3 launched, padded_to_host_csr against the
     oracle); then multihost_spgemm in one process on config 3 and
     entry.dryrun_multichip(4, devices=["cuda:0"]) (every step of the
     reference's, the dense route and the overlapped exchange among
     them). Every output tensor must be on the
     card; each against the oracle (structure exact, values rel_tol 2e-3,
     float64 1e-9); the route, the exchange's mode and the kernels the
     route launches asserted; the cold call, the median of 3
     warm calls (one on the giant row and stencil27: MESH_WARM), GFLOPS,
     peak memory, synchronizing calls (and by the port's line that makes
     them), the shards' products, K1's, K2's and
     K3's launches, and the host clock around each stage of one more warm
     call of each mesh_stream_spgemm cell; multihost_spgemm must reuse
     the config 3 needset cell's cached step;
  7g. (after 7f) the native host library (speck_tpu_torch/native) must
     build; config 3 written with store_mtx and read back with load_mtx
     and coo_to_csr, natively and by numpy, both equal to config 3, each
     stage's host time;
  7h. (after 7g) the value types and the A/B knobs (TYPE_CELLS): config 3
     in bfloat16, in float16 and as bfloat16 A times float32 B (float32
     out); config 1 in bfloat16 through DIA and with enable_dia=False
     (the dense tiles); config 3 under stream_compact_impl="scatter",
     stream_expand_impl="decode" and stream_sort_impl="bitonic", each
     timed in turns with the default call (K4 one launch a chunk a pass
     in the stream cells, "decode" too: every name runs the one expand);
     stencil27 under the scatter
     compaction; config 3 and the giant row under stream_level_factor=3
     (K2 at 3 * 8192 and 3 * 65536 slots); esc_fixed on config 1 in
     bfloat16 and float16 (K3 in 16 bits); the mesh in bfloat16 (config
     1 on its diagonal-plane route; config 3's stream route must raise
     TypeError, as the reference's does); spgemm_scipy on config 3. Each
     cell's route, output type and launches by shape and type asserted,
     its structure exact against the oracle, float32 values within
     rel_tol 2e-3, 16-bit values within compare_csr_bound of the oracle of
     the rounded inputs; the cold call, the median of 3 warm calls,
     GFLOPS, peak memory and synchronizing calls;
  7i. (after 7h) multihost_spgemm across worker processes
     (speck_tpu_torch.probes.multihost_cards: the parent starts them with
     torchrun's variables, each calls multihost.initialize() and runs its
     share of four shards): two processes sharing cuda:0 under gloo, then
     two and four processes with a card each where the machine has the
     cards (the port's own backend choice, which must be NCCL; with one
     card "multihost nccl: not run (1 card)"). Seven cases: config 3
     under needset, allgather (enable_dense=False), needset_overlap and
     pre-sharded (RowShards.from_local), config 1 on the dense route
     (allgather, enable_sdia=False) and the diagonal-plane route, the
     giant row's k-split (row 0 among the split rows). Each worker times a
     cold call and 2 warm calls, the synchronizing calls of one more, its
     peak memory and K1's and K2's launches by shape; the parent holds
     every case against the oracle (structure exact, values rel_tol
     2e-3) and the one-process mesh of four shards on cuda:0 (ranges,
     m_loc, out_cap, route, mode, exchange bytes, pair counts, n_split,
     nnz_row and columns equal, values within rel_tol 2e-3, bit-identity
     printed), the kernels each route launches in the workers, the
     overlapped exchange's bytes equal to the need-set's; under NCCL
     scaling_efficiency(phase 4's warm call, the slowest process's warm
     median, P). A failed or hung worker (MULTIHOST_TIMEOUT) fails the
     phase;
  7b. K1 at every shape phases 4, 4b, 7c, 7d, 7e, 7f, 7h and 7i launched
     it at (and the shapes of probes/contract_profile.py's table), K2 at
     every other shape phases 4, 4b, 7, 7c, 7d, 7e, 7f, 7h and 7i
     launched it at
     (widths that are not powers of two among them), checked and timed as
     in phase 3, each beside its bound, and K3 at the fixed-cap mesh's
     per-shard shape and at esc_fixed's in 16 bits as in phase 6;
  8. the gather probes' mains (python -m speck_tpu_torch.probes...) with
     their launch counts, then sublane_gather (N = 2^22, S = 2048) and
     run_copy (G = 512, K = 64, L = 128 over a 2^21 source) against their
     plain versions, exactly equal; each timed against its library call in
     turns over PROBE_REPS rounds (medians, quartiles and extremes), GB/s;
  8b. (after 8) the benchmark harness, speck_tpu_torch.bench, through
     its own functions on the matrices and oracles above: its headline
     cell (config 1: the cold call, 5 timed iterations, the # line, the
     headline JSON with bench.py's keys, scipy's median of 3 beside it),
     then config 3 with its stage split (--stages); each must pass the
     scipy oracle and config 3 must launch K1 and K2;
  8c. (after 8b) the nine stage probes (speck_tpu_torch.probes, the ports
     of scripts/profile_plan.py, mixed_probe.py, rect_probe.py,
     giant_probe.py, ab_stream.py, dense_probe.py, micro2.py,
     slice_gather_bench.py and ab_overlap.py), each split once at its
     script's size (STAGE_REPS repetitions after a warm call; the dense
     probe on config 4's plan, which has no dense group, then on config 1
     under enable_dia=False; profile_plan's loadBalanceCounting split on
     the giant row and stencil27 too), its rows printed with the card, with the
     checks of their tests: execute() equal to the complete call, the
     probes' counting chunks and records equal to the plan's (build_srec
     under each of its four variants), the dense stages composing to
     dense_tiles's output, micro2's gather variants bit-equal, the slice
     gathers equal to numpy indexing, the 8-shard mesh's two exchanges
     giving the same C; config 2's C and the mesh's against the scipy
     oracle (rel_tol 2e-3); K1 and K2 must launch; the phase's seconds;
     then K1 and K2 at every shape the phase launched them at and 7b did
     not hold, checked and timed as in 7b;
  8d. (after 8c) the seeded conformance sweep (speck_tpu_torch.probes.
     conformance: its fixed cases, then seeds 0, 1, ... for SWEEP_SECONDS
     or SWEEP_CASES cases): every route and entry point of the port at
     random shapes, value types and knobs, each case twice on the card and
     once on the CPU; plan fields equal to the CPU's, C's structure bit
     for bit, values within the sum-order bound and the scipy oracle, the
     two card runs bit-identical (the accumulator's values apart, ROADMAP.md
     standing decision 13); 0 failures, at least 200 cases, every route of
     conformance.ROUTES hit SWEEP_MIN_HITS times; then K1, K2 and K3 at
     the sweep's adversarial kernel shapes against their plain versions,
     the device analysis and routing gate past 2^24 products against
     exact counts (conformance.ANALYSIS_CASES), and K1, K2 and K3 at
     every (shape, dtype) the sweep launched them at that no phase above
     held, checked as in 7b with one timed call each;
  9. every torch.profiler session, after every CUDA-event time above: K1
     and K3 at each shape timed before (K1 but at the shapes only the
     mesh launches), their device time (the kernel and the clear of its
     scratch, medians of cp.REPS calls) beside the bound; K4's at phase
     3's three cases;
     one warm giant-row call: its device time, K1's and K2's share of it
     and its longest kernels; one warm call of each phase 7c cell, of
     the 2^20 graph and config 3 in float64 (7d) and of the dense-banded
     and accumulator cells (7e): its device time, idle share (1 - device /
     host time) and five longest kernels; then the
     probes of phase 8 in turns once
     more, to show what a profiler session before them changes, and each
     probe's and its library call's device time (medians of 5 profiled
     calls); last, one warm call of the mesh's config 3 needset, config 1
     dense, config 3 overlap, giant row and fixed-cap cells (7f) as those
     of 7c; last, one profiled overlapped step of 8c's mesh (the device
     order of K2's launches and the exchange's copies, unchecked).
Bounds (bound_ms): the bytes each function must move (inputs read once,
outputs written once) over 3.35 TB/s, the H100 SXM's device memory rate
(NVIDIA's data sheet); every kernel here is bound by bytes. library_ms is
one PyTorch call computing the same function, where there is one; the port
never calls it. Launches in the kernels' line: K1's over phases 4, 4b, 7c
(config 1b), 7e, 7f, 7h, 7i (the workers'), 8b, 8c and 8d (float32), its
double variant's over the float64 cells of 7d and 7f and 8d's, its 16-bit
variants' over 7h's config 3 cells and 8d's, K4's over 4, 7d and 7h at
the entry's own (G, W, packing, type), K2's over 4, 4b, 7, 7c, 7d,
7e, 7f, 7h, 7i, 8b, 8c and 8d (an entry of its own for the widths that
are not powers of two), K3's over 7, 7f and 8d (the
fixed cap), its double variant's over 7d's esc_fixed and its 16-bit
variants' over 7h's esc_fixed. The line's ms is the CUDA-event
time around one wrapper call, as plain_ms is; device_ms is the device time by
torch.profiler from phase 9 (K1, K3 and the probes; null for K2): where a
call is shorter on the card than its wrapper's host time, the event time
holds the host time instead.
The last lines are the kernels' JSON line, the card's nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import json
import statistics
import sys
import time

import numpy as np
import torch

from speck_tpu_torch.probes import contract_profile as cp
from speck_tpu_torch.probes.timing import (card, cuda_ms, cuda_ms_turns,
                                           device_us, profile_call,
                                           sync_sites)


HBM_BYTES_PER_MS = 3.35e12 / 1e3
# rounds of the probes' kernel-against-library timing
PROBE_REPS = 61


T0 = time.perf_counter()


def phase(name):
    """A line with the seconds since the script started, at each phase."""
    print(f"[{time.perf_counter() - T0:.1f} s] phase {name}", flush=True)


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_MS


def products_of(h):
    """Products of A·A, exactly: the B row length summed over A's
    nonzeros (the plan's own count is float32)."""
    b_len = np.diff(np.asarray(h.row_offsets, np.int64))
    return int(b_len[np.asarray(h.col_ids, np.int64)].sum())


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def bits(x):
    """A float tensor's bits, for bit-for-bit comparisons (an integer view
    of its element size: a 16-bit row of odd width has no int32 view)."""
    return x.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[x.element_size()])


def contract_case(gen, R, W, kind, dtype="float32", reps=5):
    """K1 against contract_plain at (R, W) with a rid plane or a per-row rid
    (kind "plane" or "row") and float32, float64 or 16-bit values: masks
    equal, sums within atol 1e-6 + rtol 1e-5 (float32) or rtol 1e-12
    (float64) of the run prefix's sum of magnitudes (sums in another
    order; 16-bit sums within that plus a rounding a side,
    cp.sums_close), a second
    launch bit-identical to the first; then the kernel and the plain
    version timed in turns with CUDA events around one call, medians of
    reps."""
    from speck_tpu_torch.ops import contract

    rid, col, val = cp.contract_inputs(gen, R, W, kind, dtype)
    last_k, sum_k = contract.stream_contract(rid, col, val, cp.N_COLS)
    last_2, sum_2 = contract.stream_contract(rid, col, val, cp.N_COLS)
    last_p, sum_p = contract.contract_plain(rid, col, val, cp.N_COLS)
    torch.cuda.synchronize()
    shape = (R, W, kind, dtype)
    check(torch.equal(last_k, last_p), f"K1 mask differs at {shape}")
    mag = contract.contract_plain(rid, col, val.abs(), cp.N_COLS)[1]
    err = float((sum_k - sum_p).abs().max())
    check(cp.sums_close(sum_k, sum_p, mag),
          f"K1 sums differ at {shape}: max abs {err}")
    check(torch.equal(last_k, last_2) and torch.equal(bits(sum_k),
                                                      bits(sum_2)),
          f"two K1 launches differ at {shape}")
    del last_k, sum_k, last_2, sum_2, last_p, sum_p, mag

    t = cuda_ms_turns(
        {"kernel": lambda: contract.stream_contract(rid, col, val, cp.N_COLS),
         "plain": lambda: contract.contract_plain(rid, col, val, cp.N_COLS)},
        reps)
    return (err, statistics.median(t["kernel"]),
            statistics.median(t["plain"]))


def contract_line(R, W, kind, dtype, res, smi, where=""):
    err, ms, pms = res
    print(f"K1 stream_contract ({R}, {W}) rid={kind} {dtype}{where}: "
          f"max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"bound {bound_ms(cp.k1_bytes(R, W, kind, dtype)):.4f} ms [{smi}]",
          flush=True)


def device_line(what, d, nbytes, ev_ms, smi):
    """Phase 9's line for one K1 or K3 shape: its device time by
    torch.profiler (the kernel and the clear of its scratch) beside the
    bound and the phase's CUDA-event time."""
    dms, bms = sum(d.values()), bound_ms(nbytes)
    print(f"{what}: device {dms:.4f} ms by torch.profiler (kernel "
          f"{d[cp.KERNELS[0]]:.4f}, scratch clear {d[cp.KERNELS[1]]:.4f}), "
          f"{dms / bms:.2f}x the bound {bms:.4f} ms; events around one call "
          f"{ev_ms:.4f} ms [{smi}]", flush=True)


def contract_runs_case(gen, R, W, dtype="float32"):
    """K3 against contract_runs_plain, checked as K1 in contract_case, two
    launches bit-identical; the kernel and the plain version timed."""
    from speck_tpu_torch.ops import contract

    col, val = cp.runs_inputs(gen, R, W, dtype)
    last_k, sum_k = contract.contract_runs(col, val, cp.N_COLS)
    last_2, sum_2 = contract.contract_runs(col, val, cp.N_COLS)
    last_p, sum_p = contract.contract_runs_plain(col, val, cp.N_COLS)
    torch.cuda.synchronize()
    shape = (R, W, dtype)
    check(torch.equal(last_k, last_p), f"K3 mask differs at {shape}")
    mag = contract.contract_runs_plain(col, val.abs(), cp.N_COLS)[1]
    err = float((sum_k - sum_p).abs().max())
    check(cp.sums_close(sum_k, sum_p, mag),
          f"K3 sums differ at {shape}: max abs {err}")
    check(torch.equal(last_k, last_2) and torch.equal(bits(sum_k),
                                                      bits(sum_2)),
          f"two K3 launches differ at {shape}")
    del last_k, sum_k, last_2, sum_2, last_p, sum_p, mag

    ms = cuda_ms(lambda: contract.contract_runs(col, val, cp.N_COLS))
    plain_ms = cuda_ms(lambda: contract.contract_runs_plain(col, val,
                                                            cp.N_COLS))
    return err, ms, plain_ms


def sort_case(gen, R, W, n_pay, reps=5):
    """K2 against sort_plain at (R, W, n_pay) on random keys below 2^24
    with an eighth of each row INT32_MAX (3 digit passes): keys and
    payloads equal (both sorts are stable); then K2, sort_plain and one
    torch.sort + a gather per payload timed in turns, medians of reps."""
    from speck_tpu_torch.ops import bitonic

    dev = torch.device("cuda")
    key = torch.randint(0, 1 << 24, (R, W), generator=gen, device=dev,
                        dtype=torch.int32)
    key[:, : W // 8] = 2 ** 31 - 1
    pays = [torch.randint(-(1 << 30), 1 << 30, (R, W), generator=gen,
                          device=dev, dtype=torch.int32)
            for _ in range(n_pay - 1)]
    if n_pay:
        pays.append(torch.randn((R, W), generator=gen, device=dev))
    key_k, pay_k = bitonic.row_sort(key, pays)
    key_p, pay_p = bitonic.sort_plain(key, pays)
    torch.cuda.synchronize()
    check(torch.equal(key_k, key_p), f"K2 keys differ at {(R, W, n_pay)}")
    for a, b in zip(pay_k, pay_p):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"K2 payloads differ at {(R, W, n_pay)}")
    del key_k, pay_k, key_p, pay_p

    def library():  # one unstable torch.sort, then a gather per payload
        key_s, perm = torch.sort(key, dim=1)
        return key_s, [torch.gather(p, 1, perm) for p in pays]

    t = cuda_ms_turns({"kernel": lambda: bitonic.row_sort(key, pays),
                       "plain": lambda: bitonic.sort_plain(key, pays),
                       "library": library}, reps)
    return (0.0, statistics.median(t["kernel"]),
            statistics.median(t["plain"]), statistics.median(t["library"]))


def sort_line(R, W, n_pay, res, smi, where=""):
    _, ms, pms, lms = res
    print(f"K2 row_sort ({R}, {W}) payloads={n_pay}{where}: kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, torch.sort + gather "
          f"{lms:.4f} ms ({lms / ms:.2f}x the kernel's time), bound "
          f"{bound_ms(8 * (1 + n_pay) * R * W):.4f} ms [{smi}]", flush=True)


def expand_cases(smi):
    """K4 at (512, 8192) on planned chunks in float32 packed and float64
    and bfloat16 unpacked (``expand_profile.cases``: each equal to
    expand_plain bit for bit, two launches equal), K4 and its plain
    version timed in turns, medians of 5: (the cases, {label: (events ms,
    plain ms, bound ms)})."""
    from speck_tpu_torch.probes import expand_profile as xp

    todo = xp.cases()
    k4 = {}
    for c in todo:
        k4[c.label] = xp.event_ms(c.args, 5) + (bound_ms(c.nbytes),)
        print(f"{c.label}: kernel {k4[c.label][0]:.4f} ms, plain "
              f"{k4[c.label][1]:.4f} ms, bound {k4[c.label][2]:.4f} ms, "
              f"bit-equal to the plain version [{smi}]", flush=True)
    return todo, k4


def expand_device(todo, k4, smi):
    """Phase 9's K4 lines: the device time of each of ``expand_cases``'
    cases by torch.profiler, beside its bound and its event time:
    {label: device ms}."""
    from speck_tpu_torch.probes import expand_profile as xp

    k4_dev = {}
    for c in todo:
        d = k4_dev[c.label] = xp.kernel_device_ms(c.args)
        bms = k4[c.label][2]
        print(f"{c.label}: device {d:.4f} ms by torch.profiler, "
              f"{d / bms:.2f}x the bound {bms:.4f} ms; events around one "
              f"call {k4[c.label][0]:.4f} ms [{smi}]", flush=True)
    return k4_dev


# K4's launches on the main path (check_expand in phases 4, 7d and 7h), by
# (G, W, "packed" or "unpacked", product type)
K4_MAIN = {}


def check_expand(name, plan, dtype, passes=(1, 2), main=True):
    """K4's launches since reset_counts are one a chunk of plan's stream in
    each of 1 or 2 passes (``passes``: the counts allowed), keyed by the
    chunk's (G, W), the B operand's packing and the products' type
    ``dtype``, and carry the stream's products as their live slots in
    each pass (none where the plan has no product count). With ``main``
    they are added to K4_MAIN. Returns the number of passes."""
    from speck_tpu_torch.ops import expand

    lo = plan.stream.layout
    shapes = dict(expand.LAUNCH_SHAPES)
    n = expand.LAUNCHES
    check(n == sum(shapes.values()) and lo.n_chunks > 0
          and n % lo.n_chunks == 0 and n // lo.n_chunks in passes,
          f"{name}: K4 launched {n} times over {lo.n_chunks} chunks "
          f"({shapes})")
    p = n // lo.n_chunks
    kind = "packed" if plan.A.data.dtype == torch.float32 else "unpacked"
    dname = str(dtype).replace("torch.", "")
    want = {}
    for g, k in ((lo.G, lo.n_chunks - 1), (lo.g_last, 1)):
        if k:
            key = (g, lo.W, kind, dname)
            want[key] = want.get(key, 0) + p * k
    check(shapes == want, f"{name}: K4 launches by (G, W, packing, type) "
                          f"{shapes}, not one a chunk a pass: {want}")
    live = dict(expand.LAUNCH_LIVE)
    if plan.stream.products is None:
        check(not live, f"{name}: K4 counted live slots without a count")
    else:
        check(sum(v[0] for v in live.values()) == n
              and sum(v[1] for v in live.values())
              == p * plan.stream.products,
              f"{name}: K4's live slots {live}, not {p} passes of "
              f"{plan.stream.products} products")
    if main:
        for k, v in shapes.items():
            K4_MAIN[k] = K4_MAIN.get(k, 0) + v
    return p


def expand_entries(todo, k4, k4_dev):
    """K4's entries of the kernels' JSON line, one a case of
    ``expand_cases``: launches are the main path's (K4_MAIN) at the
    entry's own (G, W, packing, type). K4 replaces no TPU kernel (the
    reference's expand is XLA)."""
    from speck_tpu_torch.ops.expand import Unpacked
    from speck_tpu_torch.probes import expand_profile as xp

    out = []
    for c in todo:
        b = c.args[5]
        kind = "unpacked" if isinstance(b, Unpacked) else "packed"
        dname = str(torch.float32 if kind == "packed" else
                    torch.promote_types(b.a_data.dtype, b.b_data.dtype)
                    ).replace("torch.", "")
        ms, pms, bms = k4[c.label]
        out.append({"name": f"stream_expand {kind} {dname}",
                    "route": "cuda",
                    "source": "speck_tpu_torch/csrc/stream_expand.cu",
                    "replaces": None,
                    "launches": K4_MAIN.get(xp.SHAPE + (kind, dname), 0),
                    "max_abs_err": c.max_abs_err, "ms": ms,
                    "device_ms": k4_dev[c.label], "plain_ms": pms,
                    "bound_ms": bms, "bound_by": "bytes",
                    "library_ms": None, "shape": list(xp.SHAPE)})
    return out


def shape_histogram(what, shapes, kernel="K2", key="payloads"):
    print(f"{kernel} launches by (R, W, {key}) in {what}: "
          f"{dict(sorted(shapes.items()))}", flush=True)


def reset_counts():
    from speck_tpu_torch.ops import bitonic, contract, expand

    contract.LAUNCHES = 0
    contract.LAUNCH_SHAPES.clear()
    contract.RUNS_LAUNCHES = 0
    contract.RUNS_LAUNCH_SHAPES.clear()
    bitonic.LAUNCHES = 0
    bitonic.LAUNCH_SHAPES.clear()
    expand.LAUNCHES = 0
    expand.LAUNCH_SHAPES.clear()
    expand.LAUNCH_LIVE.clear()


# host matrices and their oracles, made once for the cells that share them
_HOST = {}


def host_and_oracle(pt, gen_call):
    """(h, its A·A oracle, generation s, oracle s) of a generator call,
    made the first time it is asked for."""
    from speck_tpu_torch.utils import generators

    if gen_call not in _HOST:
        fn_name, args = gen_call
        t0 = time.perf_counter()
        h = getattr(generators, fn_name)(*args)
        t1 = time.perf_counter()
        ref = pt.oracle_spgemm(h, h)
        _HOST[gen_call] = (h, ref, t1 - t0, time.perf_counter() - t1)
    return _HOST[gen_call]


def sync_count(fn):
    """Synchronizing calls in one call of fn (``sync_sites``)."""
    return sum(sync_sites(fn).values())


def timed_ms(fn):
    """Host clock around one call of fn, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


CONFIG1 = ("make_banded", (65536, 16, 3))
CONFIG1B = ("make_mixed", ())
CONFIG2 = ("make_powerlaw", (131072, 12, 2.2, 5))
CONFIG3 = ("make_powerlaw", (262144, 12, 2.2, 7))
# ab_overlap's matrix (make_powerlaw(65536, avg=8, seed=5))
OVERLAP = ("make_powerlaw", (65536, 8, 2.2, 5))
GIANT = ("make_giant_row", ())
STENCIL27 = ("make_stencil27", (102, 19))
FP64_BAND = ("make_banded", (16384, 8, 9))

# the diagonal-plane cells (phase 7c): name, generator call, value dtype,
# rel_tol against the oracle
DIA_CELLS = [
    ("config 1", CONFIG1, torch.float32, 2e-3),
    ("stencil27", STENCIL27, torch.float32, 2e-3),
    ("fp64", FP64_BAND, torch.float64, 1e-9),
    ("config 1b", CONFIG1B, torch.float32, 2e-3),
]

# the general-stream cells (phase 7d): name, generator call, value dtype,
# rel_tol against the oracle, SpgemmConfig keywords
GENERAL_CELLS = [
    ("graph 2^20", ("make_powerlaw", (1 << 20, 12, 2.2, 11)), torch.float32,
     2e-3, {}),
    ("config 3 fp64", CONFIG3, torch.float64, 1e-9, {}),
    ("config 1b fp64", CONFIG1B, torch.float64, 1e-9, {}),
    ("config 3 blocked", CONFIG3, torch.float32, 2e-3,
     {"block_products": 1 << 24}),
    ("config 3 host_analysis off", CONFIG3, torch.float32, 2e-3,
     {"host_analysis": False}),
]


# the cells of phase 7e, the routes the dense tiles, the accumulator and
# the transpose opened: name, generator call, value dtype, rel_tol against
# the oracle, SpgemmConfig keywords (config 4 and the Galerkin product are
# their own cell, galerkin_cell)
SLICE_CELLS = [
    ("dense banded", CONFIG1, torch.float32, 2e-3, {"enable_dia": False}),
    ("dense mixed", CONFIG1B, torch.float32, 2e-3, {"enable_dia": False}),
    ("giant row accumulator", GIANT, torch.float32, 2e-3,
     {"enable_accum": True}),
]


def launch_counts():
    """The launch counts and shapes of K1 and K2 since reset_counts."""
    from speck_tpu_torch.ops import bitonic, contract

    return ({"stream_contract": contract.LAUNCHES,
             "row_sort": bitonic.LAUNCHES},
            (dict(contract.LAUNCH_SHAPES), dict(bitonic.LAUNCH_SHAPES)))


def products_ab(a, b):
    """Products of A·B, exactly: B's row length summed over A's nonzeros."""
    b_len = np.diff(np.asarray(b.row_offsets, np.int64))
    return int(b_len[np.asarray(a.col_ids, np.int64)].sum())


def check_host(pt, name, ref, Ch, rel_tol):
    """A host C against the oracle: finite, structure exact, values within
    rel_tol."""
    check(bool(np.isfinite(Ch.data).all()), f"non-finite values in {name}")
    r = pt.compare_csr(ref, Ch)
    check(r.ok, f"{name} structure differs from the oracle: {r.message}")
    r = pt.compare_csr(ref, Ch, compare_data=True, rel_tol=rel_tol)
    check(r.ok, f"{name} values differ from the oracle: {r.message}")


def check_oracle(pt, name, ref, C, dtype, rel_tol):
    """C (on the card) against the oracle: C's dtype the input's, then
    check_host; returns the host C."""
    check(C.data.dtype == dtype, f"{name}: C holds {C.data.dtype} values")
    Ch = pt.device_get_csr(C)
    check_host(pt, name, ref, Ch, rel_tol)
    return Ch


def warm_calls(fn, nnz, name):
    """Three warm calls of fn (each ending in a synchronize): their times
    and median; each call's nnz(C) must equal the cold call's."""
    warm = []
    for _ in range(3):
        ms, Cw = timed_ms(fn)
        check(Cw.nnz == nnz, f"{name}: warm call nnz differs")
        warm.append(ms)
        del Cw
    return warm, statistics.median(warm)


def slice_cell(pt, smi, name, gen_call, dtype, rel_tol, kw):
    """Phase 7e, one cell: spgemm of the matrix with itself under
    SpgemmConfig(**kw) through the entry points, the route asserted (pure
    dense tiles with the gather emit; dense tiles beside stream rows with
    the scatter emit, K1 and K2; the accumulator), the result against the
    oracle, the cold call, the median of 3 warm calls, GFLOPS, nnz(C)/s,
    peak memory, synchronizing calls, K1's and K2's launches by shape."""
    import importlib

    sp_mod = importlib.import_module("speck_tpu_torch.ops.spgemm")
    h, ref, t_gen, t_ref = host_and_oracle(pt, gen_call)
    cfg = pt.SpgemmConfig(**kw)
    A = pt.device_put_csr(h, dtype, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    emits = {"dense_gather_emit": 0, "dense_emit": 0}
    real = {k: getattr(sp_mod, k) for k in emits}

    def counted(k):
        def f(*a, **k2):
            emits[k] += 1
            return real[k](*a, **k2)
        return f

    reset_counts()
    plan = None

    def cold():
        nonlocal plan
        plan = pt.plan_spgemm(A, A, cfg)
        return plan.execute()

    for k in emits:
        setattr(sp_mod, k, counted(k))
    try:
        cold_ms, C = timed_ms(cold)
    finally:
        for k in emits:
            setattr(sp_mod, k, real[k])
    peak = torch.cuda.max_memory_allocated()
    launches, shapes = launch_counts()
    ss, d = plan.stream, plan.dense
    check(plan.dia is None, f"{name} took a DIA route")
    if name == "dense banded":
        check(d is not None and d.full_cover and not plan.groups
              and ss.layout.n_stream_rows == 0
              and emits["dense_gather_emit"] == 1,
              f"{name} did not run pure dense with the gather emit")
        check(launches["row_sort"] > 0 and launches["stream_contract"] == 0,
              f"{name}: launches {launches}")
    elif name == "dense mixed":
        check(d is not None and not d.full_cover
              and ss.layout.n_stream_rows > 0 and emits["dense_emit"] > 0,
              f"{name} did not run dense tiles beside stream rows")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched on {name}: {launches}")
    else:
        check(ss.n_accum > 0 and ss.rec2.n_chunks > 0,
              f"{name} did not take the accumulator")
        check(launches["row_sort"] > 0, f"{name}: launches {launches}")
    if d is not None:
        route = (f"dense tiles: {int((d.valids > 0).sum())} of "
                 f"{-(-h.rows // d.tile_rows)} tiles in "
                 f"{len(d.boffs) - 1} batches, windows kw={d.kw} cw={d.cw} "
                 f"la={d.la} lb={d.lb}, full_cover={d.full_cover}; "
                 f"{ss.layout.n_stream_rows} stream rows; emits {emits}")
    else:
        route = ""
    if ss.n_accum:
        parts = ss.accum["parts"]
        route += ("; " if route else "") + (f"accumulator: {ss.n_accum} rows, {len(parts)} parts, "
                  f"span classes {[c[:2] for pp in parts for c in pp['classes']]}"
                  f", {ss.rec2.n_chunks} chunks of {ss.rec2.G} x "
                  f"{ss.rec2.W}; {ss.layout.n_stream_rows} stream rows, "
                  f"dense tiles {d is not None}")
    nnz = plan.nnz
    t0 = time.perf_counter()
    check_oracle(pt, name, ref, C, dtype, rel_tol)
    t_ref += time.perf_counter() - t0
    del C, plan
    warm, warm_ms = warm_calls(lambda: pt.spgemm(A, A, cfg), nnz, name)
    syncs = sync_count(lambda: pt.spgemm(A, A, cfg))
    products = products_of(h)
    dname = str(dtype).replace("torch.", "")
    line = (f"{name} A*A {dname} [{smi}]: m={h.rows} nnz(A)={h.nnz} "
            f"nnz(C)={nnz} products={products}; {route}; cold "
            f"{cold_ms:.1f} ms, warm median of 3 {warm_ms:.2f} ms (all "
            f"{[round(w, 2) for w in warm]}), GFLOPS "
            f"{2 * products / (warm_ms * 1e6):.3f}, nnz(C)/s "
            f"{nnz / (warm_ms * 1e-3):.4g}, peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB "
            f"above the inputs), synchronizing calls {syncs}; launches in "
            f"the cold call {launches}; K1 by (R, W, rid, dtype) "
            f"{dict(sorted(shapes[0].items()))}; K2 by (R, W, payloads) "
            f"{dict(sorted(shapes[1].items()))}; oracle and its checks "
            f"{t_ref:.2f} s")
    print(line, flush=True)
    del A
    torch.cuda.empty_cache()
    return {"name": name, "warm_ms": warm_ms, "cold_ms": cold_ms,
            "launches": launches, "shapes": shapes, "h": h, "dtype": dtype,
            "cfg": cfg, "line": line}


def galerkin_cell(pt, smi):
    """Phase 7e, config 4 and the Galerkin product: A = bench config 1, P =
    make_prolongation(65536, 16384); A·P through spgemm (the stream, as
    the reference plans it), Pᵀ by the device transpose (equal to scipy's
    P.T exactly), then Pᵀ·(A·P), each against scipy; cold and warm times
    (median of 3), GFLOPS, nnz(C)/s, peak memory, synchronizing calls, K1's
    and K2's launches by shape over the three calls."""
    import scipy.sparse as sp

    from speck_tpu_torch.utils.generators import make_prolongation

    a, _, _, _ = host_and_oracle(pt, CONFIG1)
    t0 = time.perf_counter()
    p = make_prolongation(65536, 16384)
    As, Ps = a.to_scipy(), p.to_scipy()
    ap = (As @ Ps).tocsr()
    ap.sort_indices()
    pts = Ps.T.tocsr()
    pts.sort_indices()
    g = (pts @ ap).tocsr()
    g.sort_indices()
    refs = [pt.HostCSR.from_scipy(x) for x in (ap, pts, g)]
    t_ref = time.perf_counter() - t0
    dtype = torch.float32
    A = pt.device_put_csr(a, dtype, "cuda")
    P = pt.device_put_csr(p, dtype, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    plan = None

    def cold_ap():
        nonlocal plan
        plan = pt.plan_spgemm(A, P)
        return plan.execute()

    ap_cold, AP = timed_ms(cold_ap)
    check(plan.dia is None and plan.dense is None and plan.stream is not None
          and plan.stream.layout.n_stream_rows == a.rows,
          "config 4's A·P did not stream every row")
    lo = plan.stream.layout
    route = (f"A·P streams: W={lo.W} G={lo.G} chunks={lo.n_chunks} "
             f"n_wide={lo.n_wide} stream rows {lo.n_stream_rows}")
    del plan
    pt_cold, PT = timed_ms(lambda: pt.transpose(P))
    g_cold, G = timed_ms(lambda: pt.spgemm(PT, AP))
    peak = torch.cuda.max_memory_allocated()
    launches, shapes = launch_counts()
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on config 4: {launches}")
    check(shapes[1].get((1, 65536, 2), 0) >= 1,
          f"the transpose did not launch K2 at (1, 65536, 2): {shapes[1]}")
    t0 = time.perf_counter()
    check_oracle(pt, "config 4 A·P", refs[0], AP, dtype, 2e-3)
    pth = pt.device_get_csr(PT)
    check(np.array_equal(np.asarray(pth.row_offsets, np.int64), pts.indptr)
          and np.array_equal(np.asarray(pth.col_ids, np.int64), pts.indices)
          and np.array_equal(pth.data, pts.data.astype(np.float32)),
          "transpose(P) differs from scipy's P.T")
    check_oracle(pt, "Galerkin product", refs[2], G, dtype, 2e-3)
    t_ref += time.perf_counter() - t0
    nnz = (AP.nnz, PT.nnz, G.nnz)
    del AP, PT, G
    ap_warm, ap_ms = warm_calls(lambda: pt.spgemm(A, P), nnz[0], "A·P")
    AP = pt.spgemm(A, P)
    pt_warm, pt_ms = warm_calls(lambda: pt.transpose(P), nnz[1], "Pᵀ")
    PT = pt.transpose(P)
    g_warm, g_ms = warm_calls(lambda: pt.spgemm(PT, AP), nnz[2], "PᵀAP")
    syncs = (sync_count(lambda: pt.spgemm(A, P)),
             sync_count(lambda: pt.transpose(P)),
             sync_count(lambda: pt.spgemm(PT, AP)))
    prods = (products_ab(a, p), products_ab(refs[1], refs[0]))
    line = (f"config 4 and Galerkin f32 [{smi}]: A m={a.rows} nnz(A)="
            f"{a.nnz}, P {p.rows}x{p.cols} nnz(P)={p.nnz}; {route}; "
            f"A·P nnz(C)={nnz[0]} products={prods[0]} cold {ap_cold:.1f} ms, "
            f"warm median of 3 {ap_ms:.2f} ms (all "
            f"{[round(w, 2) for w in ap_warm]}), GFLOPS "
            f"{2 * prods[0] / (ap_ms * 1e6):.3f}, nnz(C)/s "
            f"{nnz[0] / (ap_ms * 1e-3):.4g}; transpose(P) equal to scipy's "
            f"P.T, cold {pt_cold:.2f} ms, warm median of 3 {pt_ms:.3f} ms "
            f"(all {[round(w, 3) for w in pt_warm]}); Pᵀ·(A·P) "
            f"{g.shape[0]}x{g.shape[1]} nnz(C)={nnz[2]} products={prods[1]} "
            f"cold {g_cold:.1f} ms, warm median of 3 {g_ms:.2f} ms (all "
            f"{[round(w, 2) for w in g_warm]}), GFLOPS "
            f"{2 * prods[1] / (g_ms * 1e6):.3f}, nnz(C)/s "
            f"{nnz[2] / (g_ms * 1e-3):.4g}; peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB "
            f"above the inputs); synchronizing calls (A·P, Pᵀ, PᵀAP) "
            f"{syncs}; launches in the cold calls {launches}; K1 by (R, W, "
            f"rid, dtype) {dict(sorted(shapes[0].items()))}; K2 by (R, W, "
            f"payloads) {dict(sorted(shapes[1].items()))}; scipy's products "
            f"and the checks {t_ref:.2f} s")
    print(line, flush=True)
    del A, P, AP, PT
    torch.cuda.empty_cache()
    return {"name": "config 4 and Galerkin", "launches": launches,
            "shapes": shapes, "line": line}


def dia_cell(pt, smi, name, gen_call, dtype, rel_tol):
    """Phase 7c, one cell: spgemm of the matrix with itself through the
    entry points, default SpgemmConfig(): the route asserted, the result
    against the oracle, the cold call, the median of 3 warm calls, GFLOPS,
    nnz(C)/s, peak memory, synchronizing calls; returns the numbers."""
    from speck_tpu_torch.ops import bitonic, contract

    h, ref, t_gen, t_ref = host_and_oracle(pt, gen_call)
    cfg = pt.SpgemmConfig()
    A = pt.device_put_csr(h, dtype, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    plan = None

    def cold():
        nonlocal plan
        plan = pt.plan_spgemm(A, A, cfg)
        return plan.execute()

    cold_ms, C = timed_ms(cold)
    peak = torch.cuda.max_memory_allocated()
    launches = {"stream_contract": contract.LAUNCHES,
                "row_sort": bitonic.LAUNCHES}
    shapes = (dict(contract.LAUNCH_SHAPES), dict(bitonic.LAUNCH_SHAPES))
    if name == "config 1b":
        check(plan.dia is None and plan.dia_rows is not None
              and plan.stream.layout.n_stream_rows > 0,
              "config 1b did not take the per-row DIA split beside the "
              "stream")
        check(all(v > 0 for v in launches.values()),
              f"a kernel was not launched on config 1b: {launches}")
        route = (f"per-row DIA split: spans {plan.dia_rows.span_a}, "
                 f"{plan.dia_rows.span_b}, {plan.dia_rows.span_c}; "
                 f"{plan.stream.layout.n_stream_rows} stream rows")
    else:
        check(plan.dia is not None, f"{name} did not take a DIA route")
        if name == "stencil27":
            check(plan.dia.off_a is not None
                  and h.nnz > cfg.host_analysis_max_nnz,
                  "stencil27 did not take sparse DIA through the lite gate")
        else:
            check(plan.dia.off_a is None, f"{name} took sparse DIA")
        if name == "config 1":
            check(plan.dia.uniform is not None,
                  "config 1 did not take the uniform emit")
        route = (f"{'sparse ' if plan.dia.off_a else ''}DIA: spans "
                 f"{plan.dia.span_a}, {plan.dia.span_b}, {plan.dia.span_c}; "
                 f"uniform emit {plan.dia.uniform is not None}")
    check(C.data.dtype == dtype, f"{name}: C holds {C.data.dtype} values")
    Ch = pt.device_get_csr(C)
    check(bool(np.isfinite(Ch.data).all()), f"non-finite values in {name}")
    t0 = time.perf_counter()
    r = pt.compare_csr(ref, Ch)
    check(r.ok, f"{name} structure differs from the oracle: {r.message}")
    r = pt.compare_csr(ref, Ch, compare_data=True, rel_tol=rel_tol)
    check(r.ok, f"{name} values differ from the oracle: {r.message}")
    t_ref += time.perf_counter() - t0
    del C, Ch
    warm = []
    for _ in range(3):
        ms, Cw = timed_ms(lambda: pt.spgemm(A, A, cfg))
        check(Cw.nnz == plan.nnz, f"{name}: warm call nnz differs")
        warm.append(ms)
        del Cw
    warm_ms = statistics.median(warm)
    syncs = sync_count(lambda: pt.spgemm(A, A, cfg))
    products = products_of(h)
    out = {"name": name, "warm_ms": warm_ms, "cold_ms": cold_ms,
           "launches": launches, "shapes": shapes, "h": h, "dtype": dtype}
    line = (f"{name} A*A {str(dtype).replace('torch.', '')} [{smi}]: m="
            f"{h.rows} nnz(A)={h.nnz} nnz(C)={plan.nnz} products={products}; "
            f"{route}; cold {cold_ms:.1f} ms, warm median of 3 "
            f"{warm_ms:.2f} ms (all {[round(w, 2) for w in warm]}), GFLOPS "
            f"{2 * products / (warm_ms * 1e6):.3f}, nnz(C)/s "
            f"{plan.nnz / (warm_ms * 1e-3):.4g}, peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB "
            f"above the inputs), synchronizing calls {syncs}; K1 and K2 "
            f"launches in the cold call {launches}; generated in "
            f"{t_gen:.2f} s, oracle and its checks {t_ref:.2f} s")
    print(line, flush=True)
    out["line"] = line
    if name == "config 1":
        # plan reuse with new values
        h2 = pt.HostCSR.from_parts(h.rows, h.cols, h.row_offsets, h.col_ids,
                                   h.data * 2.0 + 0.25)
        A2 = pt.device_put_csr(h2, dtype, "cuda")
        reuse_ms, C2 = timed_ms(lambda: plan.execute(A2, A2))
        r = pt.compare_csr(pt.oracle_spgemm(h2, h2), pt.device_get_csr(C2),
                           compare_data=True, rel_tol=rel_tol)
        check(r.ok, f"config 1 plan reuse differs from the oracle: "
              f"{r.message}")
        print(f"config 1 plan.execute(A2, A2): {reuse_ms:.2f} ms, matches "
              f"the oracle", flush=True)
        del A2, C2
    del A, plan
    torch.cuda.empty_cache()
    return out


def dia_profile(pt, cell, smi):
    """Phase 9, one DIA or general cell: the matrix on the card again, one
    call, then one warm call under torch.profiler: its device time, idle
    share and five longest kernels; returns the line."""
    cfg = cell.get("cfg") or pt.SpgemmConfig()
    A = pt.device_put_csr(cell.pop("h"), cell["dtype"], "cuda")
    pt.spgemm(A, A, cfg)
    host_ms, dev_ms, kernels = profile_call(lambda: pt.spgemm(A, A, cfg))
    line = (f"{cell['name']} profiled warm call: host {host_ms:.2f} ms, "
            f"device {dev_ms:.3f} ms over {sum(e.count for e in kernels)} "
            f"kernels (idle share {1 - dev_ms / host_ms:.3f}) [{smi}]; "
            "longest kernels: " + "; ".join(
                f"{e.key[:60]} {device_us(e) / 1e3:.3f} ms x{e.count}"
                for e in kernels[:5]))
    print(line, flush=True)
    del A
    torch.cuda.empty_cache()
    return line


def general_cell(pt, smi, name, gen_call, dtype, rel_tol, kw):
    """Phase 7d, one cell: spgemm of the matrix with itself through the
    entry points under SpgemmConfig(**kw): the route asserted (the table
    in the module's docstring), the result against the oracle (structure
    exact, values within rel_tol, C in the input's dtype), the cold call,
    the median of 3 warm calls, GFLOPS, nnz(C)/s, peak memory,
    synchronizing calls, and K1's, K2's and K3's launches in the cold call
    by shape and dtype; returns the numbers."""
    import importlib

    from speck_tpu_torch.ops import bitonic, contract

    sp_mod = importlib.import_module("speck_tpu_torch.ops.spgemm")
    h, ref, t_gen, t_ref = host_and_oracle(pt, gen_call)
    cfg = pt.SpgemmConfig(**kw)
    A = pt.device_put_csr(h, dtype, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    blocked = "block_products" in kw
    plan, blocks = None, []
    if blocked:
        try:
            pt.plan_spgemm(A, A, cfg)
            raised = False
        except pt.ProductOverflow:
            raised = True
        check(raised, f"{name}: plan_spgemm did not raise ProductOverflow")
        real = sp_mod.plan_spgemm

        def counting(Ab, Bb, c=None, t=None):  # the block plans, by rows
            blocks.append(Ab.shape[0])
            return real(Ab, Bb, c, t)

    reset_counts()

    def cold():
        nonlocal plan
        if blocked:
            sp_mod.plan_spgemm = counting
            try:
                return pt.spgemm(A, A, cfg)
            finally:
                sp_mod.plan_spgemm = real
        plan = pt.plan_spgemm(A, A, cfg)
        return plan.execute()

    cold_ms, C = timed_ms(cold)
    peak = torch.cuda.max_memory_allocated()
    shapes = (dict(contract.LAUNCH_SHAPES), dict(bitonic.LAUNCH_SHAPES),
              dict(contract.RUNS_LAUNCH_SHAPES))
    launches = {"stream_contract": contract.LAUNCHES,
                "row_sort": bitonic.LAUNCHES}
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on {name}: {launches}")
    dname = str(dtype).replace("torch.", "")
    check(set(k[3] for k in shapes[0]) == {dname},
          f"{name}: K1 did not run in {dname} alone: {shapes[0]}")
    check(contract.RUNS_LAUNCHES == 0, f"{name} launched K3")
    if blocked:
        n_blocks = len(blocks) - 1   # the first plan is the whole call's
        C0 = pt.spgemm(A, A, pt.SpgemmConfig())
        check(n_blocks >= 4 and sum(blocks[1:]) == h.rows,
              f"{name}: {n_blocks} row blocks {blocks[1:]}")
        check(C.nnz == C0.nnz and torch.equal(C.indptr, C0.indptr)
              and torch.equal(C.indices[:C.nnz], C0.indices[:C0.nnz]),
              f"{name}: C's structure differs from the unblocked call's")
        del C0
        route = (f"{n_blocks} row blocks of {blocks[1:]} rows under "
                 f"block_products {cfg.block_products}; plan_spgemm raised "
                 "ProductOverflow; C's structure equals the unblocked "
                 "call's")
        nnz = C.nnz
    else:
        ss = plan.stream
        check(plan.dia is None and ss is not None,
              f"{name} did not take the stream")
        lo = ss.layout
        nnz = plan.nnz
        check_expand(name, plan, dtype)
        route = (f"stream: W={lo.W} G={lo.G} chunks={lo.n_chunks} "
                 f"n_wide={lo.n_wide} r_wide={lo.r_wide} fused={ss.fused} "
                 f"pack_bits={ss.pack_bits} stream rows {lo.n_stream_rows}")
        if name == "graph 2^20":
            check(ss.pack_bits == 0 and lo.n_wide > 0,
                  f"{name}: pack_bits {ss.pack_bits}, {lo.n_wide} wide rows")
        if name == "config 1b fp64":
            check(plan.dia_rows is not None and lo.n_stream_rows > 0,
                  f"{name} did not take the per-row split beside the stream")
            route += (f"; per-row DIA split: spans {plan.dia_rows.span_a}, "
                      f"{plan.dia_rows.span_b}, {plan.dia_rows.span_c}")
        if name == "config 3 host_analysis off":
            n0 = pt.plan_spgemm(A, A, pt.SpgemmConfig()).nnz
            check(ss.dense_elig == 0 and nnz == n0,
                  f"{name}: n_elig {ss.dense_elig}, nnz {nnz} against {n0}")
            route += (f"; dense tiles counted on the device: n_elig == "
                      f"{ss.dense_elig}; nnz(C) equals the default call's")
    check(C.data.dtype == dtype, f"{name}: C holds {C.data.dtype} values")
    Ch = pt.device_get_csr(C)
    check(bool(np.isfinite(Ch.data).all()), f"non-finite values in {name}")
    t0 = time.perf_counter()
    r = pt.compare_csr(ref, Ch)
    check(r.ok, f"{name} structure differs from the oracle: {r.message}")
    r = pt.compare_csr(ref, Ch, compare_data=True, rel_tol=rel_tol)
    check(r.ok, f"{name} values differ from the oracle: {r.message}")
    t_ref += time.perf_counter() - t0
    del C, Ch, plan
    warm = []
    for _ in range(3):
        ms, Cw = timed_ms(lambda: pt.spgemm(A, A, cfg))
        check(Cw.nnz == nnz, f"{name}: warm call nnz differs")
        warm.append(ms)
        del Cw
    warm_ms = statistics.median(warm)
    syncs = sync_count(lambda: pt.spgemm(A, A, cfg))
    products = products_of(h)
    line = (f"{name} A*A {dname} [{smi}]: m={h.rows} nnz(A)={h.nnz} "
            f"nnz(C)={nnz} products={products}; {route}; cold "
            f"{cold_ms:.1f} ms, warm median of 3 {warm_ms:.2f} ms (all "
            f"{[round(w, 2) for w in warm]}), GFLOPS "
            f"{2 * products / (warm_ms * 1e6):.3f}, nnz(C)/s "
            f"{nnz / (warm_ms * 1e-3):.4g}, peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB "
            f"above the inputs), synchronizing calls {syncs}; launches in "
            f"the cold call {launches}; K1 by (R, W, rid, dtype) "
            f"{dict(sorted(shapes[0].items()))}; K2 by (R, W, payloads) "
            f"{dict(sorted(shapes[1].items()))}; generated in {t_gen:.2f} "
            f"s, oracle and its checks {t_ref:.2f} s")
    print(line, flush=True)
    del A
    torch.cuda.empty_cache()
    return {"name": name, "warm_ms": warm_ms, "cold_ms": cold_ms,
            "launches": launches, "shapes": shapes, "h": h, "dtype": dtype,
            "cfg": cfg, "line": line}


def esc_phase(pt, smi, dtype="float32"):
    """Phase 7 (float32, then entry()) and 7d (float64): esc_fixed on bench
    config 1 against the oracle; returns the launch counts of that call,
    K2's launches by shape, the summary line and the warm time."""
    from speck_tpu_torch import entry as tentry
    from speck_tpu_torch.ops import bitonic, contract
    from speck_tpu_torch.ops.esc import esc_fixed
    from speck_tpu_torch.parallel import padded_to_host_csr

    h, ref, _, _ = host_and_oracle(pt, CONFIG1)
    cap = tentry.fixed_cap(h, h)
    check(cap == 2048, f"config 1 fixed cap is {cap}, not 2048")
    products = products_of(h)
    args = tentry.esc_args(h, h, "cuda", np.dtype(dtype))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    out = esc_fixed(*args, cap=cap, n_cols=h.cols)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = {"contract_runs": contract.RUNS_LAUNCHES,
                "row_sort": bitonic.LAUNCHES}
    shapes = dict(bitonic.LAUNCH_SHAPES)
    k3_shapes = dict(contract.RUNS_LAUNCH_SHAPES)
    peak = torch.cuda.max_memory_allocated()
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the esc_fixed path: {launches}")
    check(contract.LAUNCHES == 0, "the esc_fixed path launched K1")
    check(set(k[2] for k in k3_shapes) == {dtype},
          f"K3 did not run in {dtype} on esc_fixed: {k3_shapes}")
    check(out[2].dtype == getattr(torch, dtype),
          f"esc_fixed returned {out[2].dtype} values")
    got = padded_to_host_csr(*out, h.rows, h.cols)
    r = pt.compare_csr(ref, got)
    check(r.ok, f"esc_fixed structure differs from the oracle: {r.message}")
    r = pt.compare_csr(ref, got, compare_data=True,
                       rel_tol=1e-9 if dtype == "float64" else 2e-3)
    check(r.ok, f"esc_fixed values differ from the oracle: {r.message}")
    check(bool(np.isfinite(got.data).all()), "non-finite values in C")
    del out
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        esc_fixed(*args, cap=cap, n_cols=h.cols)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    warm_ms = statistics.median(warm)
    syncs = sync_count(lambda: esc_fixed(*args, cap=cap, n_cols=h.cols))
    line = (f"esc_fixed config 1 A*A {dtype} cap {cap} [{smi}]: nnz(C)="
            f"{got.nnz} products={products} cold {cold_ms:.1f} ms, warm "
            f"median of 3 {warm_ms:.2f} ms (all "
            f"{[round(w, 2) for w in warm]}), GFLOPS "
            f"{2 * products / (warm_ms * 1e6):.3f}, nnz(C)/s "
            f"{got.nnz / (warm_ms * 1e-3):.4g}, peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB "
            f"above the inputs), synchronizing calls {syncs}; launches "
            f"{launches}, K3 by (R, W, dtype) {k3_shapes}")
    print(line, flush=True)
    shape_histogram(f"one esc_fixed call on config 1 ({dtype})", shapes)
    if dtype == "float64":
        return launches, shapes, line, warm_ms

    a, b = tentry._example_matrices()
    fn, eargs = tentry.entry()
    got = padded_to_host_csr(*fn(*eargs), a.rows, b.cols)
    r = pt.compare_csr(pt.oracle_spgemm(a, b), got, compare_data=True,
                       rel_tol=2e-3)
    check(r.ok, f"entry() differs from the oracle: {r.message}")
    print("entry(): fn(*args) on the card matches the oracle", flush=True)
    return launches, shapes, line, warm_ms


def giant_phase(pt, smi):
    """Phase 4b: spgemm on the bench's giant row against the oracle; returns
    the launch counts and shapes of the cold call and the summary line."""
    from speck_tpu_torch.ops import bitonic, contract

    h, ref, t_gen, t_ref = host_and_oracle(pt, GIANT)
    check((h.rows, h.nnz) == (40000, 50084873),
          f"the giant row is {(h.rows, h.nnz)}, not the bench's")
    cfg = pt.SpgemmConfig()
    A = pt.device_put_csr(h, torch.float32, "cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    plan = pt.plan_spgemm(A, A, cfg)
    C = plan.execute()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = {"stream_contract": contract.LAUNCHES,
                "row_sort": bitonic.LAUNCHES}
    k1_shapes = dict(contract.LAUNCH_SHAPES)
    k2_shapes = dict(bitonic.LAUNCH_SHAPES)
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the giant-row path: {launches}")
    check(contract.RUNS_LAUNCHES == 0, "the giant-row path launched K3")
    lo = plan.stream.layout
    classes = plan.stream.finish["classes"] or []
    print(f"giant row: m={h.rows} nnz(A)={h.nnz} generated in {t_gen:.2f} "
          f"s, oracle {t_ref:.2f} s; layout W={lo.W} G={lo.G} "
          f"chunks={lo.n_chunks} n_wide={lo.n_wide} r_wide={lo.r_wide} "
          f"fused={plan.stream.fused} finish classes "
          f"{[(c['R2'], c['W2']) for c in classes]} ladder_levels="
          f"{plan.stream.finish['ladder_levels']}; launches {launches}",
          flush=True)
    shape_histogram("the giant-row plan_spgemm + execute", k2_shapes)
    shape_histogram("the giant-row plan_spgemm + execute", k1_shapes, "K1",
                    "rid, dtype")
    check(lo.n_wide > 0 and classes,
          "the giant row planned no wide rows or no finish class")
    Ch = pt.device_get_csr(C)
    r = pt.compare_csr(ref, Ch)
    check(r.ok, f"giant row structure differs from the oracle: {r.message}")
    r = pt.compare_csr(ref, Ch, compare_data=True, rel_tol=2e-3)
    check(r.ok, f"giant row values differ from the oracle: {r.message}")
    check(bool(np.isfinite(Ch.data).all()), "non-finite values in C")

    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Cw = pt.spgemm(A, A, cfg)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        check(Cw.nnz == C.nnz, "warm call nnz differs from the cold call")
        del Cw
    warm_ms = statistics.median(warm)
    products = products_of(h)
    line = (f"giant row A*A f32 [{smi}]: nnz(C)={C.nnz} products="
            f"{products} cold {cold_ms:.1f} ms, warm median of 3 "
            f"{warm_ms:.1f} ms (all {[round(w, 1) for w in warm]}), GFLOPS "
            f"{2 * products / (warm_ms * 1e6):.3f}; launches {launches}")
    print(line, flush=True)
    return {"launches": launches, "k1_shapes": k1_shapes,
            "k2_shapes": k2_shapes, "line": line, "h": h, "cfg": cfg,
            "warm_ms": warm_ms}


def giant_profile(pt, giant, smi):
    """Phase 9: the giant row put on the card again, one call, then one
    warm call under torch.profiler: its device time, K1's share (the
    contract and the clears of its scratch) and K2's, and its longest
    kernels; returns the summary line with them."""
    cfg = giant.pop("cfg")
    A = pt.device_put_csr(giant.pop("h"), torch.float32, "cuda")
    pt.spgemm(A, A, cfg)
    host_ms, dev_ms, kernels = profile_call(lambda: pt.spgemm(A, A, cfg))
    k1_ms = sum(device_us(e) for e in kernels
                if any(n in e.key for n in cp.KERNELS)) / 1e3
    k2_ms = sum(device_us(e) for e in kernels
                if "radix_tile_kernel" in e.key
                or "merge_pass_kernel" in e.key) / 1e3
    print(f"giant row profiled warm call: host {host_ms:.1f} ms, device "
          f"{dev_ms:.2f} ms over {sum(e.count for e in kernels)} kernels "
          f"(idle share {1 - dev_ms / host_ms:.3f}); K1 {k1_ms:.3f} ms "
          f"with its scratch clears ({k1_ms / dev_ms:.1%} of the device "
          f"time), K2 {k2_ms:.3f} ms ({k2_ms / dev_ms:.1%}) [{smi}]",
          flush=True)
    print("giant row profiled warm call, longest kernels: " + "; ".join(
        f"{e.key[:60]} {device_us(e) / 1e3:.3f} ms x{e.count}"
        for e in kernels[:6]), flush=True)
    return (f"{giant['line']}; profiled call: device {dev_ms:.2f} ms (K1 "
            f"{k1_ms:.3f}, K2 {k2_ms:.3f})")


def probe_phase(gen, smi):
    """Phase 8: the probes' mains with their launch counts, then each probe
    kernel against its plain version at the scripts' sizes; returns the
    counts, the cases and each kernel's measured numbers."""
    from speck_tpu_torch.probes import expand_microbench as em
    from speck_tpu_torch.probes import gather_microbench2 as gm

    for k in gm.LAUNCHES:
        gm.LAUNCHES[k] = 0
    gm.main()
    em.main([])
    launches = dict(gm.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"a probe kernel was not launched by the probes: {launches}")

    dev = torch.device("cuda")
    N, S = 1 << 22, 2048
    tab = torch.randn((S, 128), generator=gen, device=dev)
    idx = torch.randint(0, S, (N // 128, 128), generator=gen, device=dev,
                        dtype=torch.int32)
    check(torch.equal(gm.sublane_gather(idx, tab),
                      gm.sublane_gather_plain(idx, tab)),
          "sublane_gather differs from its plain version")
    idx64 = idx.long()
    g_bytes = 4 * N + 4 * S * 128 + 4 * N

    G, K, L, n = 512, 64, 128, 1 << 21
    src = torch.randn(n, generator=gen, device=dev)
    offs = torch.randint(0, n - L + 1, (G, K), generator=gen, device=dev,
                         dtype=torch.int32)
    check(torch.equal(gm.run_copy(offs, src, L),
                      gm.run_copy_plain(offs, src, L)),
          "run_copy differs from its plain version")
    ix = (offs.long()[..., None] + torch.arange(L, device=dev)).reshape(-1)
    # source elements this run's offsets cover (each read once)
    edge = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    flat = offs.reshape(-1).long()
    edge.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    edge.index_add_(0, flat + L, -torch.ones_like(flat, dtype=torch.int32))
    covered = int((torch.cumsum(edge, 0) > 0).sum())
    c_bytes = 4 * G * K + 4 * covered + 4 * G * K * L

    # each kernel and its library call in turns, PROBE_REPS rounds
    cases = {
        "sublane_gather": (g_bytes, "torch.gather",
                           lambda: gm.sublane_gather(idx, tab),
                           lambda: gm.sublane_gather_plain(idx, tab),
                           lambda: torch.gather(tab, 0, idx64)),
        "run_copy": (c_bytes, "one indexing call",
                     lambda: gm.run_copy(offs, src, L),
                     lambda: gm.run_copy_plain(offs, src, L),
                     lambda: src[ix])}
    return launches, cases, probe_turns(cases, launches, smi)


def probe_turns(cases, launches, smi, where=""):
    """Each probe kernel and its library call in turns, PROBE_REPS rounds;
    returns each kernel's measured numbers."""
    out = {}
    for name, (nbytes, lib_name, kernel, plain, library) in cases.items():
        t = cuda_ms_turns({"kernel": kernel, "library": library},
                          PROBE_REPS)
        m = {"max_abs_err": 0.0, "ms": statistics.median(t["kernel"]),
             "plain_ms": cuda_ms(plain), "bound_ms": bound_ms(nbytes),
             "bound_by": "bytes",
             "library_ms": statistics.median(t["library"])}
        out[name] = m

        def spread(v):  # min, quartiles, max
            q = statistics.quantiles(v, n=4)
            return ", ".join(f"{x:.4f}" for x in (min(v), q[0], q[2], max(v)))

        wins = sum(a < b for a, b in zip(t["kernel"], t["library"]))
        print(f"{name}{where}: kernel {m['ms']:.4f} ms "
              f"({nbytes / m['ms'] / 1e6:.1f} GB/s), {lib_name} "
              f"{m['library_ms']:.4f} ms, medians of {PROBE_REPS} in turns "
              f"(min, quartiles, max: kernel {spread(t['kernel'])}; library "
              f"{spread(t['library'])}); kernel faster in {wins} of "
              f"{PROBE_REPS} turns; plain {m['plain_ms']:.4f} ms, bound "
              f"{m['bound_ms']:.4f} ms; launches in the probes "
              f"{launches[name]} [{smi}]", flush=True)
    return out


# the mesh cells of phase 7f: name, generator call (None: the block-diagonal
# product), exchange, value dtype, rel_tol against the oracle, SpgemmConfig
# keywords, the route the reference's gates take and the exchange's mode
MESH_CELLS = [
    ("mesh config 3 needset", CONFIG3, "needset", torch.float32, 2e-3, {},
     "stream", "needset"),
    ("mesh config 3 allgather", CONFIG3, "allgather", torch.float32, 2e-3,
     {}, "stream", "allgather"),
    ("mesh config 3 fp64 needset", CONFIG3, "needset", torch.float64, 1e-9,
     {}, "stream", "needset"),
    ("mesh giant row needset", GIANT, "needset", torch.float32, 2e-3, {},
     "stream", "needset"),
    ("mesh block-diagonal needset", None, "needset", torch.float32, 2e-3,
     {}, "stream", "needset"),
    ("mesh config 1 sdia", CONFIG1, "needset", torch.float32, 2e-3, {},
     "sdia", "dia_halo"),
    ("mesh stencil27 sdia", STENCIL27, "needset", torch.float32, 2e-3, {},
     "sdia", "dia_halo"),
    ("mesh fp64 sdia", FP64_BAND, "needset", torch.float64, 1e-9, {},
     "sdia", "dia_halo"),
    ("mesh config 1 dense", CONFIG1, "allgather", torch.float32, 2e-3,
     {"enable_sdia": False}, "dense", "dense_allgather"),
    ("mesh config 3 overlap", CONFIG3, "needset_overlap", torch.float32,
     2e-3, {}, "stream", "needset_overlap"),
]
# the kernels each mesh route launches (the diagonal planes none)
ROUTE_KERNELS = {"stream": ("stream_contract", "row_sort"),
                 "dense": ("row_sort",), "sdia": ()}
MESH_SHARDS = 4
# warm calls of a mesh cell: 3, but one on the two slowest (~2.5-3 s a
# call), whose spread the script's time budget cannot pay for
MESH_WARM = {"mesh giant row needset": 1, "mesh stencil27 sdia": 1}
# the phase 7f cells that are phase 7i's one-process references (the same
# call: matrix, exchange, SpgemmConfig, float32), by 7i's case name; their
# cold call's outputs (multihost_cards.summary) are kept in MESH_REFS
SHARED_REFS = {"mesh config 3 needset": "needset",
               "mesh config 3 overlap": "overlap",
               "mesh giant row needset": "ksplit",
               "mesh config 1 sdia": "banded",
               "mesh config 1 dense": "dense"}
MESH_REFS = {}


def block_diagonal(pt):
    """scipy's block_diag of MESH_SHARDS copies of make_powerlaw(65536,
    seed=7), and its oracle (made once)."""
    import scipy.sparse as sp

    from speck_tpu_torch.utils.generators import make_powerlaw

    key = ("block_diag", MESH_SHARDS)
    if key not in _HOST:
        t0 = time.perf_counter()
        blk = make_powerlaw(65536, seed=7).to_scipy()
        h = pt.HostCSR.from_scipy(sp.block_diag([blk] * MESH_SHARDS,
                                                format="csr"))
        t1 = time.perf_counter()
        _HOST[key] = (h, pt.oracle_spgemm(h, h), t1 - t0,
                      time.perf_counter() - t1)
    return _HOST[key]


def mesh_counts():
    """K1's, K2's and K3's launches and shapes since reset_counts."""
    from speck_tpu_torch.ops import bitonic, contract

    return ({"stream_contract": contract.LAUNCHES,
             "row_sort": bitonic.LAUNCHES,
             "contract_runs": contract.RUNS_LAUNCHES},
            (dict(contract.LAUNCH_SHAPES), dict(bitonic.LAUNCH_SHAPES),
             dict(contract.RUNS_LAUNCH_SHAPES)))


def shard_products(h, ranges):
    """Products of A·A in each shard's row range."""
    b_len = np.diff(np.asarray(h.row_offsets, np.int64))
    per_row = np.add.reduceat(
        b_len[np.asarray(h.col_ids, np.int64)],
        np.minimum(np.asarray(h.row_offsets[:-1], np.int64),
                   max(h.nnz - 1, 0))) if h.nnz else np.zeros(h.rows)
    per_row = np.where(np.diff(h.row_offsets) > 0, per_row, 0)
    return [int(per_row[r0:r1].sum()) for r0, r1 in ranges]


def mesh_run(fn, name):
    """The cold call of fn (after reset_counts), its launches, peak memory
    and host time; every output tensor must be on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    cold_ms, out = timed_ms(fn)
    peak = torch.cuda.max_memory_allocated()
    launches, shapes = mesh_counts()
    for x in out[:3]:
        check(x.device.type == "cuda", f"{name}: an output is on {x.device}")
    return cold_ms, out, launches, shapes, peak, base_mem


# the stages of mesh_stream_spgemm that host_stages times: its module's
# functions, and the two steps (which enqueue the shards' card work)
MESH_STAGES = ("_shard_row_lens", "_host_row_ops", "_mesh_sdia_gate",
               "_mesh_dense_gate", "_plan_ksplit_shards", "_stack_shards",
               "tight_total_host", "_mesh_wide_plans", "put",
               "_plan_needset_device", "_lut_gather")


def host_stages(fn):
    """One call of fn with the host clock around each stage of
    mesh_stream_spgemm (MESH_STAGES, RowShards.from_global and the step's
    call; a stage inside another counts in the outer one): {stage: (ms,
    calls)}, "other" for the rest of the call until its return, and
    "card after return" for the synchronize that follows it (the card's
    work still queued when the host is done)."""
    from speck_tpu_torch.parallel import mesh_stream as ms

    clock = {}
    depth = [0]

    def timed(name, f):
        def run(*a, **k):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    t, n = clock.get(name, (0.0, 0))
                    clock[name] = (t + (time.perf_counter() - t0) * 1e3,
                                   n + 1)
        return run

    saved = {n: getattr(ms, n) for n in MESH_STAGES}
    calls = {c: c.__call__ for c in (ms._AllgatherStep, ms._NeedsetStep,
                                     ms._OverlapStep, ms._SdiaStep,
                                     ms._DenseStep)}
    from_global = ms.RowShards.__dict__["from_global"]
    try:
        for n, f in saved.items():
            setattr(ms, n, timed(n, f))
        for c, f in calls.items():
            c.__call__ = timed("step", f)
        ms.RowShards.from_global = classmethod(
            timed("RowShards.from_global", from_global.__func__))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        for n, f in saved.items():
            setattr(ms, n, f)
        for c, f in calls.items():
            c.__call__ = f
        ms.RowShards.from_global = from_global
    clock["other"] = ((t1 - t0) * 1e3 - sum(t for t, _ in clock.values()),
                      1)
    clock["card after return"] = ((t2 - t1) * 1e3, 1)
    return clock


def mesh_warm(fn, name, nnz_total):
    """The cell's warm calls (MESH_WARM, else 3; nnz(C) each equal to
    the cold call's), their median, and the synchronizing calls of one
    more by site (sync_sites)."""
    warm = []
    for _ in range(MESH_WARM.get(name, 3)):
        ms, out = timed_ms(fn)
        check(int(out[0].sum()) == nnz_total, f"{name}: warm nnz differs")
        warm.append(ms)
        del out
    return warm, statistics.median(warm), sync_sites(fn)


def mesh_cell(pt, smi, name, gen_call, exchange, dtype, rel_tol, kw, route,
              mode_want):
    """Phase 7f, one cell: mesh_stream_spgemm of the matrix with itself
    over MESH_SHARDS shards on one card (make_row_mesh(4,
    devices=["cuda:0"])), the route and the exchange's mode asserted (and
    the kernels the route launches: ROUTE_KERNELS), the result against
    the oracle, the cold call, the median of 3 warm calls, GFLOPS, peak
    memory, synchronizing calls, the shards' products and K1's, K2's and
    K3's launches; returns the numbers."""
    from speck_tpu_torch.parallel import make_row_mesh, mesh_stream_spgemm
    from speck_tpu_torch.parallel import mesh_stream as ms
    from speck_tpu_torch.probes import multihost_cards as mc

    if gen_call is None:
        h, ref, t_gen, t_ref = block_diagonal(pt)
    else:
        h, ref, t_gen, t_ref = host_and_oracle(pt, gen_call)
    mesh = make_row_mesh(MESH_SHARDS, devices=["cuda:0"])

    cfg = pt.SpgemmConfig(**kw)

    def call():
        return mesh_stream_spgemm(h, h, mesh, cfg, exchange=exchange,
                                  dtype=dtype)

    cold_ms, out, launches, shapes, peak, base_mem = mesh_run(call, name)
    meta = out[3]
    st, ks = meta["stats"], meta["ksplit"]
    check(meta["route"] == route, f"{name}: route {meta['route']}")
    for k, n in launches.items():
        check((n > 0) == (k in ROUTE_KERNELS[route]),
              f"{name} ({route}): launches {launches}")
    dname = str(dtype).replace("torch.", "")
    if route == "stream":
        check(set(k[3] for k in shapes[0]) == {dname},
              f"{name}: K1 did not run in {dname} alone: {shapes[0]}")
    # all_gather reports no stats (as the reference): every shard
    # receives all of B's 8- or 12-byte records
    mode = st.mode if st is not None else "allgather"
    rec = 12 if dtype == torch.float64 else 8
    ns_bytes = st.needset_bytes if st is not None else None
    ag_bytes = st.allgather_bytes if st is not None else h.nnz * rec
    check(mode == mode_want, f"{name}: exchange ran as {mode}")
    planes = ""
    if route == "sdia":
        step = ms.last_exec()[0]
        nd = tuple(len(x) for x in (step.off_a, step.off_b, step.off_c))
        planes = (f"; planes A {nd[0]}, B {nd[1]}, C {nd[2]}, halo "
                  f"{step.halo_l} + {step.halo_r} rows")
        if gen_call == STENCIL27:
            check(nd == (27, 27, 125), f"{name}: planes {nd}")
    elif route == "dense":
        step = ms.last_exec()[0]
        planes = (f"; {step.K} tiles of {step.tr} rows a shard, kw "
                  f"{step.kw}, cw {step.cw}, la {step.la}, lb {step.lb}")
    if gen_call == GIANT:
        check(ks is not None and ks["n_split"] >= 1 and 0 in ks["split_ids"],
              f"{name}: the k-split did not engage: {ks}")
    elif gen_call is None:
        check(st.needset_bytes == 0 and st.zero_comm,
              f"{name}: {st.needset_bytes} bytes exchanged")
        q = h.rows // MESH_SHARDS
        check([tuple(r) for r in meta["ranges"]]
              == [(d * q, (d + 1) * q) for d in range(MESH_SHARDS)],
              f"{name}: ranges {meta['ranges']}")
    else:
        check(ks is None, f"{name}: unexpected k-split {ks}")
    t0 = time.perf_counter()
    fields, arrays = mc.summary(out)
    Ch = mc.host_csr(arrays, fields["shape"])
    if name in SHARED_REFS:
        MESH_REFS[SHARED_REFS[name]] = (fields, arrays)
    check(Ch.data.dtype == np.dtype(dname), f"{name}: C holds {Ch.data.dtype}")
    check(bool(np.isfinite(Ch.data).all()), f"non-finite values in {name}")
    r = pt.compare_csr(ref, Ch)
    check(r.ok, f"{name} structure differs from the oracle: {r.message}")
    r = pt.compare_csr(ref, Ch, compare_data=True, rel_tol=rel_tol)
    check(r.ok, f"{name} values differ from the oracle: {r.message}")
    t_ref += time.perf_counter() - t0
    nnz = Ch.nnz
    del out, Ch, arrays
    warm, warm_ms, sites = mesh_warm(call, name, nnz)
    syncs = sum(sites.values())
    products = products_of(h)
    line = (f"{name} A*A {dname} [{smi}; {MESH_SHARDS} shards on one card, "
            f"run one after another]: m={h.rows} nnz(A)={h.nnz} "
            f"nnz(C)={nnz} products={products}; ranges {meta['ranges']}, "
            f"shard products {shard_products(h, meta['ranges'])}, m_loc "
            f"{meta['m_loc']}, out_cap {meta['out_cap']}; route {route}"
            f"{planes}; exchange {mode}: needset_bytes {ns_bytes}, "
            f"allgather_bytes {ag_bytes}; k-split {ks}; cold {cold_ms:.1f} ms, "
            f"warm median of {len(warm)} {warm_ms:.2f} ms (all "
            f"{[round(w, 2) for w in warm]}), GFLOPS "
            f"{2 * products / (warm_ms * 1e6):.3f}, peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB "
            f"above the inputs), synchronizing calls {syncs}; launches in "
            f"the cold call {launches}; K1 by (R, W, rid, dtype) "
            f"{dict(sorted(shapes[0].items()))}; K2 by (R, W, payloads) "
            f"{dict(sorted(shapes[1].items()))}; generated in {t_gen:.2f} "
            f"s, oracle and its checks {t_ref:.2f} s")
    print(line, flush=True)
    print(f"{name} synchronizing calls by site: {dict(sites.most_common())}",
          flush=True)
    stages = host_stages(call)
    print(f"{name} host stages of one warm call [{smi}] (ms, calls): "
          + ", ".join(f"{k} {t:.1f} x{n}" for k, (t, n) in sorted(
              stages.items(), key=lambda kv: -kv[1][0])), flush=True)
    torch.cuda.empty_cache()
    return {"name": name, "warm_ms": warm_ms, "cold_ms": cold_ms,
            "launches": launches, "shapes": shapes, "dtype": dtype,
            "line": line, "call": call, "needset_bytes": ns_bytes}


def mesh_fixed_cap_cell(pt, smi):
    """Phase 7f: mesh_spgemm_fixed_cap on bench config 1 over MESH_SHARDS
    shards on one card: K2 and K3 launched, padded_to_host_csr against the
    oracle."""
    from speck_tpu_torch.parallel import (make_row_mesh,
                                          mesh_spgemm_fixed_cap,
                                          padded_to_host_csr)
    from speck_tpu_torch.parallel.dist import stack_row_shards

    name = "mesh fixed cap config 1"
    h, ref, t_gen, t_ref = host_and_oracle(pt, CONFIG1)
    mesh = make_row_mesh(MESH_SHARDS, devices=["cuda:0"])

    def call():
        return mesh_spgemm_fixed_cap(h, h, mesh)

    cold_ms, out, launches, shapes, peak, base_mem = mesh_run(call, name)
    check(launches["row_sort"] > 0 and launches["contract_runs"] > 0,
          f"a kernel was not launched on {name}: {launches}")
    check(launches["stream_contract"] == 0, f"{name} launched K1")
    C = padded_to_host_csr(*out, h.rows, h.cols)
    r = pt.compare_csr(ref, C)
    check(r.ok, f"{name} structure differs from the oracle: {r.message}")
    r = pt.compare_csr(ref, C, compare_data=True, rel_tol=2e-3)
    check(r.ok, f"{name} values differ from the oracle: {r.message}")
    nnz, cap = C.nnz, out[1].shape[1]
    del out, C
    warm, warm_ms, sites = mesh_warm(call, name, nnz)
    syncs = sum(sites.values())
    products = products_of(h)
    ranges = stack_row_shards(h, MESH_SHARDS)[3]
    line = (f"{name} A*A float32 [{smi}; {MESH_SHARDS} shards on one card, "
            f"run one after another]: m={h.rows} nnz(C)={nnz} products="
            f"{products}, cap {cap}; shard products "
            f"{shard_products(h, ranges)}; cold {cold_ms:.1f} ms, warm "
            f"median of 3 {warm_ms:.2f} ms (all {[round(w, 2) for w in warm]}"
            f"), GFLOPS {2 * products / (warm_ms * 1e6):.3f}, peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB "
            f"above the inputs), synchronizing calls {syncs}; launches in "
            f"the cold call {launches}; K2 by (R, W, payloads) "
            f"{dict(sorted(shapes[1].items()))}; K3 by (R, W, dtype) "
            f"{dict(sorted(shapes[2].items()))}")
    print(line, flush=True)
    print(f"{name} synchronizing calls by site: {dict(sites.most_common())}",
          flush=True)
    torch.cuda.empty_cache()
    return {"name": name, "warm_ms": warm_ms, "cold_ms": cold_ms,
            "launches": launches, "shapes": shapes, "dtype": torch.float32,
            "line": line, "call": call}


def mesh_profile(cell, smi):
    """Phase 9, one mesh cell: one warm call under torch.profiler, its
    device time (the four shards' kernels on the one card), idle share
    and five longest kernels; returns the line."""
    host_ms, dev_ms, kernels = profile_call(cell.pop("call"))
    check(kernels, f"{cell['name']}: the profile recorded no kernel")
    line = (f"{cell['name']} profiled warm call: host {host_ms:.2f} ms, "
            f"device {dev_ms:.3f} ms over {sum(e.count for e in kernels)} "
            f"kernels (idle share {1 - dev_ms / host_ms:.3f}) [{smi}; "
            f"{MESH_SHARDS} shards on one card]; longest kernels: "
            + "; ".join(f"{e.key[:60]} {device_us(e) / 1e3:.3f} ms "
                        f"x{e.count}" for e in kernels[:5]))
    print(line, flush=True)
    torch.cuda.empty_cache()
    return line


def mesh_dryrun_cell(pt, smi, needset_call):
    """Phase 7f: multihost_spgemm in one process on config 3 after one
    more call of the needset cell (``needset_call``; the step cache holds
    the last few plans, fewer than phase 7f makes): the cell's cached step
    must be reused; then entry.dryrun_multichip over MESH_SHARDS shards on
    one card."""
    from speck_tpu_torch.entry import dryrun_multichip
    from speck_tpu_torch.parallel import (make_row_mesh,
                                          mesh_stream_to_host_csr)
    from speck_tpu_torch.parallel import multihost

    reset_counts()
    multihost.initialize()
    check(multihost.local_row_range(100) == (0, 100),
          "one process owns every row")
    h, ref, _, _ = host_and_oracle(pt, CONFIG3)
    mesh = make_row_mesh(MESH_SHARDS, devices=["cuda:0"])
    needset_call()
    ms, out = timed_ms(lambda: multihost.multihost_spgemm(h, h, mesh=mesh))
    check(out[3]["compiled_reused"], "multihost_spgemm built a new step")
    r = pt.compare_csr(ref, mesh_stream_to_host_csr(*out), compare_data=True,
                       rel_tol=2e-3)
    check(r.ok, f"multihost_spgemm differs from the oracle: {r.message}")
    t0 = time.perf_counter()
    line = dryrun_multichip(MESH_SHARDS, devices=["cuda:0"])
    dry_s = time.perf_counter() - t0
    launches, shapes = mesh_counts()
    check(launches["stream_contract"] > 0 and launches["row_sort"] > 0,
          f"a kernel was not launched in the dryrun: {launches}")
    text = (f"mesh dryrun [{smi}; {MESH_SHARDS} shards on one card]: "
            f"multihost_spgemm (one process) on config 3: {ms:.1f} ms, "
            f"compiled_reused {out[3]['compiled_reused']}, matches the "
            f"oracle; {line} ({dry_s:.1f} s)")
    print(text, flush=True)
    del out
    torch.cuda.empty_cache()
    return {"name": "mesh dryrun", "launches": launches,
            "shapes": shapes, "dtype": torch.float32, "line": text}


# phase 7i: a worker still running after this many seconds fails the phase
MULTIHOST_TIMEOUT = 300


def multihost_phase(pt, smi, config3_warm):
    """Phase 7i: multihost_spgemm across worker processes on the card
    (speck_tpu_torch.probes.multihost_cards, its CASES: config 3 under the
    need-set, all_gather and overlapped exchanges and pre-sharded, config
    1 on the dense and diagonal-plane routes, the giant row's k-split),
    four shards in all: two processes sharing cuda:0 under gloo, then,
    where there are two cards or four, two or four processes with a card
    each under the port's own backend choice, which must be NCCL. The
    workers get the matrices of the earlier phases through a temporary
    directory; the parent holds every case against the oracles of the
    earlier phases and the one-process mesh on cuda:0 (multihost_cards.
    hold; phase 7f's cold call where 7f ran the same call,
    SHARED_REFS), asserts the kernels each route launches in the workers
    (ROUTE_KERNELS) and that the overlapped exchange moved the need-set
    exchange's bytes, and under NCCL prints scaling_efficiency with phase
    4's warm call as T1. Returns K1's and K2's launches by shape in the
    workers, summed over the runs."""
    from speck_tpu_torch.probes import multihost_cards as mc

    mats, oracles = {}, {}
    for name, call in mc.MATRICES.items():
        mats[name], oracles[name], _, _ = host_and_oracle(pt, call)
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    runs = [("gloo", 2)] + [(None, p) for p in (2, 4) if n_cards >= p]
    k1, k2 = {}, {}
    for backend, procs in runs:
        rep = mc.run(mc.CASES, mats, procs, backend, "cuda",
                     timeout=MULTIHOST_TIMEOUT, oracles=oracles,
                     refs=MESH_REFS, t1_ms=config3_warm, smi=smi,
                     log=lambda line: print(line, flush=True))
        want = backend or "nccl"
        check(rep["backend"] == want, f"multihost P={procs}: the workers "
              f"took {rep['backend']}, not {want}")
        cases = rep["cases"]
        check(cases["overlap"]["fields"]["needset_bytes"]
              == cases["needset"]["fields"]["needset_bytes"],
              f"multihost {want}: the overlapped exchange moved other "
              "bytes than the need-set exchange")
        for case in mc.CASES:
            cold = np.sum([n["cold_launches"]
                           for n in cases[case.name]["per_rank"]], axis=0)
            ran = {"stream_contract": cold[0], "row_sort": cold[1]}
            for k, n in ran.items():
                check((n > 0) == (k in ROUTE_KERNELS[case.route]),
                      f"multihost {want} {case.name} ({case.route}): "
                      f"launches {ran}")
        for src, dst in ((rep["k1"], k1), (rep["k2"], k2)):
            for k, n in src.items():
                dst[k] = dst.get(k, 0) + n
        bits = [c for c in cases if cases[c]["bit_identical"]]
        print(f"multihost {want} P={procs} [{smi}]: {len(cases)} cases held "
              f"in {rep['seconds']:.1f} s (workers {rep['worker_s']:.1f} s), "
              f"bit-identical to the one-process mesh: {bits}; K1 launches "
              f"{sum(rep['k1'].values())}, K2 {sum(rep['k2'].values())}",
              flush=True)
    if n_cards < 2:
        print(f"multihost nccl: not run ({n_cards} card)", flush=True)
    return k1, k2


def native_mtx_cell(pt, smi):
    """Phase 7g: the native host library must build here; config 3 written
    with store_mtx and read with load_mtx and coo_to_csr, natively and by
    numpy (the library switched off), the arrays of both equal to each
    other and to config 3's; each stage's host time."""
    import tempfile
    from pathlib import Path

    from speck_tpu_torch import native
    from speck_tpu_torch.formats.csr import HostCOO, coo_to_csr
    from speck_tpu_torch.formats.mtx import load_mtx, store_mtx

    t0 = time.perf_counter()
    check(native.available(), "the native host library did not build")
    build_s = time.perf_counter() - t0
    h = host_and_oracle(pt, CONFIG3)[0]
    rows = np.repeat(np.arange(h.rows, dtype=np.uint32),
                     np.diff(np.asarray(h.row_offsets, np.int64)))
    coo = HostCOO(rows=h.rows, cols=h.cols, row_ids=rows,
                  col_ids=np.asarray(h.col_ids, np.uint32),
                  data=np.asarray(h.data, np.float64))
    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    times, got = {}, {}
    lib = native._lib
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        for path in ("native", "numpy"):
            if path == "numpy":
                native._lib, native._failed = None, True
            try:
                f = str(Path(tmp) / f"{path}.mtx")
                t0 = time.perf_counter()
                store_mtx(f, coo)
                t1 = time.perf_counter()
                back = load_mtx(f, np.float64)
                t2 = time.perf_counter()
                csr = coo_to_csr(back)
                t3 = time.perf_counter()
            finally:
                native._lib, native._failed = lib, False
            times[path] = (t1 - t0, t2 - t1, t3 - t2)
            got[path] = csr
    for path, csr in got.items():
        for k in ("row_offsets", "col_ids", "data"):
            check(np.array_equal(np.asarray(getattr(csr, k)),
                                 np.asarray(getattr(h, k))),
                  f".mtx round trip ({path}): {k} differs from config 3's")
    line = (f"native host library [{smi}; the card machine's host]: built "
            f"and loaded in {build_s:.2f} s; config 3 (nnz {h.nnz}) "
            + "; ".join(f"{p}: store_mtx {a:.2f} s, load_mtx {b:.2f} s, "
                        f"coo_to_csr {c:.2f} s" for p, (a, b, c)
                        in times.items())
            + "; both round trips equal config 3")
    print(line, flush=True)
    return line

# the cells of phase 7h, the value types and the A/B knobs: name, generator
# call, A's and B's value dtypes, SpgemmConfig keywords, the route the
# gates take ("stream", "dia" or "dense"); a knob cell (kw) times its
# default call beside it
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
TYPE_CELLS = [
    ("config 3 bf16", CONFIG3, BF16, BF16, {}, "stream"),
    ("config 3 f16", CONFIG3, F16, F16, {}, "stream"),
    ("config 3 bf16 x f32", CONFIG3, BF16, F32, {}, "stream"),
    ("config 1 bf16", CONFIG1, BF16, BF16, {}, "dia"),
    ("config 1 bf16 dense", CONFIG1, BF16, BF16, {"enable_dia": False},
     "dense"),
    ("config 3 scatter", CONFIG3, F32, F32,
     {"stream_compact_impl": "scatter"}, "stream"),
    ("config 3 decode", CONFIG3, F32, F32,
     {"stream_expand_impl": "decode"}, "stream"),
    ("config 3 bitonic", CONFIG3, F32, F32, {"stream_sort_impl": "bitonic"},
     "stream"),
    ("stencil27 scatter", STENCIL27, F32, F32,
     {"stream_compact_impl": "scatter"}, "dia"),
    # merge levels at 3 * 8192 and 3 * 65536 slots: max widths that keep
    # the first level's factor at 3 and send the widest rows up the ladder
    ("config 3 level factor 3", CONFIG3, F32, F32,
     {"stream_level_factor": 3, "stream_max_width": 3 * 8192}, "stream"),
    ("giant row level factor 3", GIANT, F32, F32,
     {"stream_level_factor": 3, "stream_max_width": 1 << 20}, "stream"),
]


def rounded_host(pt, h, dtype):
    """h with its values rounded to dtype (held as float64)."""
    return pt.HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                      col_ids=h.col_ids, data=torch.as_tensor(
                          np.asarray(h.data)).to(dtype).double().numpy())


def check_typed(pt, name, h, ref, Ch, dta, dtb, dtc):
    """Ch (host C of dtc values) against the oracle: structure exact;
    16-bit values within compare_csr_bound of the oracle of the rounded
    inputs, float32 within rel_tol 2e-3 (of that oracle where an input is
    16-bit, else of ``ref``)."""
    from speck_tpu_torch.utils.compare import compare_csr_bound

    check(bool(np.isfinite(Ch.data).all()), f"non-finite values in {name}")
    ha, hb = rounded_host(pt, h, dta), rounded_host(pt, h, dtb)
    if dtc in (BF16, F16):
        r = compare_csr_bound(ha, hb, Ch, dtc)
    else:
        if dta != F32 or dtb != F32:
            ref = pt.oracle_spgemm(ha, hb)
        r = pt.compare_csr(ref, Ch)
        check(r.ok, f"{name} structure differs from the oracle: {r.message}")
        r = pt.compare_csr(ref, Ch, compare_data=True, rel_tol=2e-3)
    check(r.ok, f"{name} differs from the oracle: {r.message}")


def type_cell(pt, smi, name, gen_call, dta, dtb, kw, route):
    """Phase 7h, one cell: spgemm through the entry points with A in dta
    and B in dtb under SpgemmConfig(**kw): the route and the output type
    (the reference's: a float32 A gives float32, else the promoted type)
    asserted, the kernels the route launches and their dtypes, the result
    against the oracle (check_typed), the cold call, the median of 3 warm
    calls (a knob cell in turns with the default call), GFLOPS, peak
    memory, synchronizing calls, K1's, K2's and K3's launches by shape and
    type, K4's one a chunk a pass (check_expand); returns the numbers."""
    from speck_tpu_torch.ops import bitonic, contract

    h, ref, t_gen, t_ref = host_and_oracle(pt, gen_call)
    cfg = pt.SpgemmConfig(**kw)
    A = pt.device_put_csr(h, dta, "cuda")
    B = A if dtb == dta else pt.device_put_csr(h, dtb, "cuda")
    dtc = F32 if dta == F32 else torch.promote_types(dta, dtb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    plan = None

    def cold():
        nonlocal plan
        plan = pt.plan_spgemm(A, B, cfg)
        return plan.execute()

    cold_ms, C = timed_ms(cold)
    peak = torch.cuda.max_memory_allocated()
    shapes = (dict(contract.LAUNCH_SHAPES), dict(bitonic.LAUNCH_SHAPES),
              dict(contract.RUNS_LAUNCH_SHAPES))
    launches = {"stream_contract": contract.LAUNCHES,
                "row_sort": bitonic.LAUNCHES}
    check(C.data.dtype == dtc, f"{name}: C holds {C.data.dtype}, not {dtc}")
    got = ("dia" if plan.dia is not None else
           "dense" if plan.dense is not None else "stream")
    check(got == route, f"{name}: took the {got} route")
    if route == "stream":
        check_expand(name, plan, dtc)
    want = {"stream": {"stream_contract", "row_sort"}, "dia": set(),
            "dense": {"row_sort"}}[route]
    check({k for k, n in launches.items() if n} == want,
          f"{name} ({route}): launches {launches}")
    dname = str(dtc).replace("torch.", "")
    if route == "stream":
        check(set(k[3] for k in shapes[0]) == {dname},
              f"{name}: K1 did not run in {dname} alone: {shapes[0]}")
    if kw.get("stream_level_factor") == 3:
        odd = {s: n for s, n in shapes[1].items() if s[1] & (s[1] - 1)}
        check(odd, f"{name}: no K2 launch at a width that is not a power "
                   f"of two: {shapes[1]}")
    t0 = time.perf_counter()
    Ch = pt.device_get_csr(C)
    check_typed(pt, name, h, ref, Ch, dta, dtb, dtc)
    t_ref += time.perf_counter() - t0
    nnz = plan.nnz
    del C, Ch, plan
    knob = bool(kw) and "enable_dia" not in kw
    default = pt.SpgemmConfig()
    runs = {"cell": lambda: pt.spgemm(A, B, cfg)}
    if knob:
        runs["default"] = lambda: pt.spgemm(A, B, default)
    warm = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            ms, Cw = timed_ms(fn)
            check(Cw.nnz == nnz, f"{name}: warm call nnz differs")
            warm[k].append(ms)
            del Cw
    warm_ms = statistics.median(warm["cell"])
    beside = (f"; the default call in turns "
              f"{statistics.median(warm['default']):.2f} ms (all "
              f"{[round(w, 2) for w in warm['default']]})" if knob else "")
    syncs = sync_count(runs["cell"])
    products = products_of(h)
    line = (f"{name} A*A {str(dta)[6:]} x {str(dtb)[6:]} -> {dname} {kw} "
            f"[{smi}]: m={h.rows} nnz(A)={h.nnz} nnz(C)={nnz} "
            f"products={products}; route {route}; cold {cold_ms:.1f} ms, "
            f"warm median of 3 {warm_ms:.2f} ms (all "
            f"{[round(w, 2) for w in warm['cell']]}){beside}, GFLOPS "
            f"{2 * products / (warm_ms * 1e6):.3f}, peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base_mem) / 2**30:.2f} GiB "
            f"above the inputs), synchronizing calls {syncs}; launches in "
            f"the cold call {launches}; K1 by (R, W, rid, dtype) "
            f"{dict(sorted(shapes[0].items()))}; K2 by (R, W, payloads) "
            f"{dict(sorted(shapes[1].items()))}; oracle and its checks "
            f"{t_ref:.2f} s")
    print(line, flush=True)
    del A, B
    torch.cuda.empty_cache()
    return {"name": name, "warm_ms": warm_ms, "cold_ms": cold_ms,
            "launches": launches, "shapes": shapes, "dtype": dtc,
            "line": line}


def esc16_cell(pt, smi):
    """Phase 7h: esc_fixed on config 1 in bfloat16 and in float16 (K3 in
    16 bits, K2 moving the values by slot): the output type, the result
    within the 16-bit bound, the cold and warm calls; returns the launch
    counts and shapes."""
    from speck_tpu_torch import entry as tentry
    from speck_tpu_torch.ops import bitonic, contract
    from speck_tpu_torch.ops.esc import esc_fixed
    from speck_tpu_torch.parallel import padded_to_host_csr

    h, _, _, _ = host_and_oracle(pt, CONFIG1)
    cap = tentry.fixed_cap(h, h)
    launches = {"contract_runs": 0, "row_sort": 0}
    shapes = ({}, {}, {})
    for dt in (BF16, F16):
        args = list(tentry.esc_args(h, h, "cuda", np.dtype("float64")))
        args[2], args[6] = args[2].to(dt), args[6].to(dt)
        reset_counts()
        cold_ms, out = timed_ms(lambda: esc_fixed(*args, cap=cap,
                                                  n_cols=h.cols))
        launches["contract_runs"] += contract.RUNS_LAUNCHES
        launches["row_sort"] += bitonic.LAUNCHES
        cold_k2 = dict(bitonic.LAUNCH_SHAPES)
        cold_k3 = dict(contract.RUNS_LAUNCH_SHAPES)
        shapes[1].update(cold_k2)
        shapes[2].update(cold_k3)
        dname = str(dt)[6:]
        check(contract.RUNS_LAUNCHES > 0 and bitonic.LAUNCHES > 0
              and contract.LAUNCHES == 0,
              f"esc_fixed {dname}: launches K3 {contract.RUNS_LAUNCHES}, "
              f"K2 {bitonic.LAUNCHES}, K1 {contract.LAUNCHES}")
        check(set(k[2] for k in contract.RUNS_LAUNCH_SHAPES) == {dname},
              f"K3 did not run in {dname}: {contract.RUNS_LAUNCH_SHAPES}")
        check(out[2].dtype == dt, f"esc_fixed returned {out[2].dtype}")
        got = padded_to_host_csr(*out, h.rows, h.cols)
        check_typed(pt, f"esc_fixed {dname}", h, None, got, dt, dt, dt)
        del out
        warm = [timed_ms(lambda: esc_fixed(*args, cap=cap,
                                           n_cols=h.cols))[0]
                for _ in range(3)]
        products = products_of(h)
        wm = statistics.median(warm)
        print(f"esc_fixed config 1 A*A {dname} cap {cap} [{smi}]: nnz(C)="
              f"{got.nnz} products={products} cold {cold_ms:.1f} ms, warm "
              f"median of 3 {wm:.2f} ms (all {[round(w, 2) for w in warm]}),"
              f" GFLOPS {2 * products / (wm * 1e6):.3f}; in the cold call "
              f"K3 by (R, W, dtype) {cold_k3}, K2 by (R, W, payloads) "
              f"{cold_k2}", flush=True)
        del args
        torch.cuda.empty_cache()
    return {"name": "esc_fixed 16-bit", "launches": launches,
            "shapes": shapes}


def mesh16_cell(pt, smi):
    """Phase 7h: the mesh in bfloat16, four shards on one card: config 1
    on the diagonal-plane route (needset) against the 16-bit bound; config
    3 under needset raises TypeError, as the reference's stream mesh
    raises (it packs B's values as 32-bit words)."""
    from speck_tpu_torch.parallel import (make_row_mesh, mesh_stream_spgemm,
                                          mesh_stream_to_host_csr)

    mesh = make_row_mesh(MESH_SHARDS, devices=["cuda:0"])
    h, _, _, _ = host_and_oracle(pt, CONFIG1)

    def call():
        return mesh_stream_spgemm(h, h, mesh, pt.SpgemmConfig(),
                                  exchange="needset", dtype=BF16)

    cold_ms, out = timed_ms(call)
    check(out[3]["route"] == "sdia" and out[2].dtype == BF16
          and out[2].device.type == "cuda",
          f"mesh config 1 bf16: route {out[3]['route']}, {out[2].dtype}")
    Ch = mesh_stream_to_host_csr(*out)
    check_typed(pt, "mesh config 1 bf16", h, None, Ch, BF16, BF16, BF16)
    del out
    warm = [timed_ms(call)[0] for _ in range(3)]
    h3, _, _, _ = host_and_oracle(pt, CONFIG3)
    try:
        mesh_stream_spgemm(h3, h3, mesh, pt.SpgemmConfig(),
                           exchange="needset", dtype=BF16)
        raised = False
    except TypeError:
        raised = True
    check(raised, "the mesh stream route ran in bfloat16")
    print(f"mesh config 1 bf16 needset [{smi}; {MESH_SHARDS} shards on one "
          f"card]: route sdia, nnz(C)={Ch.nnz}, cold {cold_ms:.1f} ms, warm "
          f"median of 3 {statistics.median(warm):.2f} ms (all "
          f"{[round(w, 2) for w in warm]}); config 3 bf16 needset raised "
          "TypeError (the stream mesh packs 32-bit values, as the "
          "reference)", flush=True)
    torch.cuda.empty_cache()


def scipy_cell(pt, smi):
    """Phase 7h: spgemm_scipy on config 3 (scipy in and out, float32 on
    the card) against the oracle."""
    h, ref, _, _ = host_and_oracle(pt, CONFIG3)
    a = h.to_scipy()
    cold_ms, c = timed_ms(lambda: pt.spgemm_scipy(a, a))
    check(c.dtype == np.float32, f"spgemm_scipy gave {c.dtype}")
    got = pt.HostCSR.from_scipy(c)
    r = pt.compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    check(r.ok, f"spgemm_scipy differs from the oracle: {r.message}")
    warm = [timed_ms(lambda: pt.spgemm_scipy(a, a))[0] for _ in range(3)]
    print(f"spgemm_scipy config 3 float32 [{smi}]: nnz(C)={c.nnz}, cold "
          f"{cold_ms:.1f} ms, warm median of 3 {statistics.median(warm):.2f}"
          f" ms (all {[round(w, 2) for w in warm]}), upload and download "
          "included", flush=True)


def bench_phase(pt, smi):
    """Phase 8b: the benchmark harness (speck_tpu_torch.bench) through its
    own functions, on the matrices and oracles of the earlier phases: the
    headline cell (config 1) with its headline line, then config 3 with
    its stage split. Each must pass its oracle check; the headline must
    carry bench.py's keys. Returns K1's and K2's launches in this phase."""
    from speck_tpu_torch import bench

    cells = {c.tag: c for c in bench.CELLS}
    reset_counts()
    h1, ref1, _, _ = host_and_oracle(pt, CONFIG1)
    r1 = bench.run_cell(cells["config1"], h1, None, ref1, "cuda")
    print(r1.line(), flush=True)
    check(r1.oracle_ok, f"bench config 1: {r1.oracle_msg}")
    head = bench.headline(r1, bench.scipy_median_ms(h1))
    print(json.dumps(head), f"[{smi}]", flush=True)
    check(list(head) == ["metric", "value", "unit", "vs_baseline"]
          and head["metric"] == bench.METRIC and head["value"] > 0,
          f"the bench headline is missing or malformed: {head}")
    h3, ref3, _, _ = host_and_oracle(pt, CONFIG3)
    r3 = bench.run_cell(cells["config3"], h3, None, ref3, "cuda",
                        stages=True)
    print(r3.line(), flush=True)
    for line in r3.stage_lines():
        print(line, flush=True)
    check(r3.oracle_ok, f"bench config 3: {r3.oracle_msg}")
    check(r3.stages["complete"] > 0, "bench config 3: no stage split")
    counts, _ = launch_counts()
    check(all(counts.values()), f"bench config 3 launched {counts}")
    return counts


# the stage probes' repetitions in phase 8c (each after one warm call)
STAGE_REPS = 2


def stage_rows(name, rows, smi):
    from speck_tpu_torch.probes.split import print_rows

    print(f"stage probe {name}:", flush=True)
    print_rows(rows, smi)
    return {r[0]: r[3] for r in rows}


def csr_equal(X, Y):
    """Two DeviceCSR results equal in structure and value bits."""
    return (X.nnz == Y.nnz and torch.equal(X.indptr, Y.indptr)
            and torch.equal(X.indices[: X.nnz], Y.indices[: Y.nnz])
            and torch.equal(X.data[: X.nnz], Y.data[: Y.nnz]))


def tuple_equal(xs, ys):
    return len(xs) == len(ys) and all(torch.equal(x, y)
                                      for x, y in zip(xs, ys))


def staged_equal(plan, c, stg, n_products):
    """A probe's chunk c (stream_chunk as the counting loop calls it)
    equal to the plan's staged chunk, compacted first where the plan
    compacted its raw chunks (C has duplicates)."""
    from speck_tpu_torch.ops.stream import compact_staged
    from speck_tpu_torch.probes.split import chunk_is_raw

    if chunk_is_raw(plan, c) and plan.nnz != n_products:
        stg = compact_staged(*stg, n_cols=plan.shape[1])
    return tuple_equal(stg, plan.stream.staged[c])


def stage_probe_phase(pt, smi):
    """Phase 8c: the nine stage probes (speck_tpu_torch.probes, the ports
    of scripts/profile_plan.py ... ab_overlap.py), each split once at its
    script's size with STAGE_REPS repetitions, through the port's own
    functions, its rows printed with the card; the checks of their tests:
    execute() and the chunk probes' staged chunks and records equal the
    plan's, the dense stages compose to dense_tiles's output, micro2's
    gather variants bit-equal, the slice gathers equal their plain
    indexing, the mesh's two exchanges give the same C. Returns (K1's and
    K2's launches in the phase, their shapes, the overlapped mesh step
    for phase 9's schedule, the seconds)."""
    from speck_tpu_torch.probes import (ab_overlap, ab_stream, dense_probe,
                                        giant_probe, micro2, mixed_probe,
                                        profile_plan, rect_probe,
                                        slice_gather_bench)
    from speck_tpu_torch.probes.split import layout_line
    from speck_tpu_torch.probes.timing import cuda_ms
    from speck_tpu_torch.utils import generators

    t0 = time.perf_counter()
    reset_counts()
    R = STAGE_REPS
    f32 = torch.float32
    h1 = host_and_oracle(pt, CONFIG1)[0]
    A1 = pt.device_put_csr(h1, f32, "cuda")

    by = stage_rows("profile_plan config1",
                    profile_plan.split(A1, reps=R), smi)
    check(csr_equal(by["dia execute()"], pt.spgemm(A1, A1)),
          "profile_plan: execute() differs from spgemm")

    h1b = host_and_oracle(pt, CONFIG1B)[0]
    A1b = pt.device_put_csr(h1b, f32, "cuda")
    by = stage_rows("mixed_probe config 1b", mixed_probe.split(A1b, reps=R),
                    smi)
    print(mixed_probe.routes_line(by["routes"]), flush=True)
    check(csr_equal(by["execute (staged)"], by["complete"]),
          "mixed_probe: execute() differs from the complete call")
    del A1b

    hp = generators.make_prolongation(65536, 16384)
    P = pt.device_put_csr(hp, f32, "cuda")
    by = stage_rows("rect_probe config 4", rect_probe.split(A1, P, reps=R),
                    smi)
    plan4 = by["layout"]
    ss = plan4.stream
    check(ss is not None and ss.layout.total_q > 0,
          "rect_probe: config 4 did not take the stream")
    print(layout_line(plan4), flush=True)
    n4 = products_ab(h1, hp)
    check(all(staged_equal(plan4, c, stg, n4)
              for c, (_, stg) in enumerate(by["counting chunks"])),
          "rect_probe: a counting chunk differs from the plan's")
    r = ss.rec
    check(tuple_equal(by["build_srec (compact=True, pack=False)"],
                      (r.p0, r.su, r.sa, r.src, r.pend))
          and tuple_equal(by["build_srec (compact=True, pack=True)"],
                          (r.p0, r.su, r.sa, r.src, r.pend))
          and tuple_equal(by["build_srec (compact=False, pack=True)"],
                          by["build_srec (compact=False, pack=False)"]),
          "rect_probe: build_srec differs from the plan's records")
    check(csr_equal(by["execute (staged gather emit)"],
                    by["spgemm complete"]),
          "rect_probe: execute() differs from the complete call")
    print(f"dense_probe config4: {dense_probe.group_line(plan4)}"
          + ("" if plan4.dense else "; no dense group; counting is "
             "elsewhere"), flush=True)
    del P, plan4, ss, r, by

    planb = pt.plan_spgemm(A1, A1, pt.SpgemmConfig(enable_dia=False))
    print(f"dense_probe dense_banded: {dense_probe.group_line(planb)}",
          flush=True)
    by = stage_rows("dense_probe dense_banded", dense_probe.split(planb, R),
                    smi)
    whole = by["dense_tiles whole"][1]
    check(tuple_equal(by["compaction sort"], whole)
          and tuple_equal(whole, planb.dense_staged[0]),
          "dense_probe: the stages do not compose to dense_tiles")
    del planb, by, whole
    torch.cuda.empty_cache()

    hg = host_and_oracle(pt, GIANT)[0]
    AG = pt.device_put_csr(hg, f32, "cuda")
    by = stage_rows("giant_probe", giant_probe.split(AG, reps=R), smi)
    plang = by["full plan_spgemm"]
    print(layout_line(plang), flush=True)
    check(all(staged_equal(plang, 0, by[f"full chunk (stage, compact)[{s}]"]
                           [1], 0) for s in giant_probe.CHUNK_SORTS),
          "giant_probe: chunk 0 differs from the plan's")
    del plang, by
    # loadBalanceCounting split on the two cells past host_analysis_max_nnz
    # (profile_plan giant_row and stencil27), here in an old process
    for name, A, step in (("giant_row", AG, "plan_device_stream"),
                          ("stencil27", None,
                           "_plan_sdia (spGEMMCounting, allocC)")):
        if A is None:
            A = pt.device_put_csr(host_and_oracle(pt, STENCIL27)[0], f32,
                                  "cuda")
        rows = profile_plan.lbc_split(A, reps=R)
        by = stage_rows(f"profile_plan {name} (old process)", rows, smi)
        print(profile_plan.sum_line(rows, smi), flush=True)
        check(step in by, f"profile_plan {name}: no {step} step")
        del A, rows, by
        torch.cuda.empty_cache()
    del AG

    h2, ref2 = host_and_oracle(pt, CONFIG2)[:2]
    A2 = pt.device_put_csr(h2, f32, "cuda")
    by = stage_rows("ab_stream config 2", ab_stream.split(A2, reps=R), smi)
    plan2 = by["layout"]
    c = min(1, plan2.stream.layout.n_chunks - 1)
    check(staged_equal(plan2, c, by["full chunk (stage_raw)"][1],
                       products_ab(h2, h2)),
          "ab_stream: the chunk differs from the plan's")
    check(all(csr_equal(by[f"config2 {n}"], by["execute() fused"])
              for n, _ in ab_stream.VARIANTS),
          "ab_stream: a sort variant's C differs")
    check_oracle(pt, "ab_stream config 2", ref2, by["execute() fused"], f32,
                 2e-3)
    del A2, plan2, by
    torch.cuda.empty_cache()

    cols, vals, src = micro2.gather_inputs("cuda")
    rows = micro2.gather_split(cols, vals, src, R)
    (c0, v0), (c1, v1) = rows[0][3], rows[1][3]
    check(torch.equal(c0, c1) and torch.equal(v0.view(torch.int32),
                                              v1.view(torch.int32)),
          "micro2: the gather variants differ")
    stage_rows("micro2 gathers", rows, smi)
    for label, fn in micro2.gather_calls(cols, vals, src).items():
        print(f"  {label}: device {cuda_ms(fn, R):.3f} ms by CUDA events "
              f"[{smi}]", flush=True)
    del cols, vals, src, rows, c0, v0, c1, v1
    stage_rows("micro2 config 1 planning", micro2.plan_split(A1, reps=R),
               smi)

    M, RW = 1 << 22, 16
    arrays = slice_gather_bench.inputs(M, RW, "cuda")
    by = stage_rows("slice_gather_bench", slice_gather_bench.split(
        *arrays, RW, R), smi)
    tab, _, idx, st = (x.cpu().numpy() for x in arrays)
    want = tab[np.clip(st, 0, tab.shape[0] - RW)[:, None] + np.arange(RW)]
    check(np.array_equal(by["A element gather"].cpu().numpy(), tab[idx])
          and np.array_equal(by["B slice gather"].cpu().numpy(), want)
          and np.array_equal(by["E lax.gather slices"].cpu().numpy(), want),
          "slice_gather_bench: a gather differs from its plain indexing")
    for label, fn in slice_gather_bench.calls(*arrays, RW).items():
        print(f"  {label}: device {cuda_ms(fn, R):.4f} ms by CUDA events "
              f"[{smi}]", flush=True)
    del arrays, by, tab, idx, st, want

    ha, refa = host_and_oracle(pt, OVERLAP)[:2]
    mesh = ab_overlap.mesh_of(torch.device("cuda"))
    rows = ab_overlap.split(ha, mesh, iters=R)
    ab_overlap.check_equal(rows)
    check_host(pt, "ab_overlap's 8-shard mesh", refa,
               ab_overlap.host_c(rows[0]), 2e-3)
    for label, med, mn, o in rows:
        print(f"stage probe ab_overlap {label} ({mesh.size} shards on "
              f"{sorted({str(d) for d in mesh.devices})}): first "
              f"{o['first_ms']:.1f} ms, warm step median {med:.1f} ms, min "
              f"{mn:.1f} ms, nnz={o['nnz']} [{smi}]", flush=True)
    step = rows[1][3]["step"]
    del rows
    counts, shapes = launch_counts()
    seconds = time.perf_counter() - t0
    print(f"phase 8c: the nine stage probes in {seconds:.1f} s; launches "
          f"{counts} [{smi}]", flush=True)
    check(all(counts.values()), f"phase 8c launched {counts}")
    return counts, shapes, (step, mesh, ha.rows), seconds


# phase 8d: the conformance sweep's time budget (s) and its most cases (240:
# the fewest at which every route is hit SWEEP_MIN_HITS times, the
# accumulator's fifth hit being case 239); the routes it must hit, each at
# least SWEEP_MIN_HITS times
SWEEP_SECONDS = 90
SWEEP_CASES = 240
SWEEP_MIN_HITS = 5


def conformance_phase(smi):
    """Phase 8d: the seeded conformance sweep (speck_tpu_torch.probes.
    conformance) on the card, its fixed cases first, then seeds 0, 1, ...
    until SWEEP_CASES cases or SWEEP_SECONDS: every case twice on the card
    and once on the CPU, plan fields equal, C's structure bit for bit,
    values within the sum-order bound and the oracle, the two card runs
    bit-identical (the accumulator's values apart: ROADMAP.md standing
    decision 13). Then the kernels at its adversarial shapes against their
    plain versions (launches not counted) and its analysis cases. It must
    end with 0 failures, at least 200 cases and every route of
    conformance.ROUTES hit SWEEP_MIN_HITS times. Returns the sweep's
    launch shapes: (K1's, K2's), K3's."""
    from speck_tpu_torch.ops import contract
    from speck_tpu_torch.probes import conformance as cf

    reset_counts()
    report = cf.sweep("cuda", cases=SWEEP_CASES, seconds=SWEEP_SECONDS,
                      kernels=False)
    counts, shapes = launch_counts()
    k3_shapes = dict(contract.RUNS_LAUNCH_SHAPES)
    print(f"phase 8d: {report.summary()}; launches {counts}, K3 "
          f"{contract.RUNS_LAUNCHES} [{smi}]", flush=True)
    check(not report.failures, f"the conformance sweep failed "
          f"{len(report.failures)} cases: {report.failures[:3]}")
    check(report.cases >= 200, f"the sweep ran {report.cases} cases")
    thin = {r: report.routes[r] for r in cf.ROUTES
            if report.routes[r] < SWEEP_MIN_HITS}
    check(not thin, f"routes hit fewer than {SWEEP_MIN_HITS} times: {thin}")
    kernels = cf.Report(device=report.device)
    t0 = time.perf_counter()
    cf.sweep_direct("cuda", kernels)
    print(f"phase 8d: {kernels.kernel_cases} kernel cases at adversarial "
          f"shapes against their plain versions and analysis cases past "
          f"2^24 products against exact counts in "
          f"{time.perf_counter() - t0:.1f} s, {len(kernels.failures)} "
          f"failures [{smi}]", flush=True)
    check(not kernels.failures, f"kernel cases failed: "
          f"{kernels.failures[:3]}")
    return shapes, k3_shapes


def overlap_schedule_line(overlap, smi):
    """The device order of one profiled overlapped step of phase 8c's
    mesh (ab_overlap.schedule), its reports under build/; no check: after
    the sessions before it the profiler may record no device event."""
    from speck_tpu_torch.probes import ab_overlap

    (fn, args), mesh, m = overlap
    sched = ab_overlap.schedule(fn, args)
    entries, before, ranges = sched
    n_k2 = sum(1 for e in entries if e[0] == "K2")
    return (f"ab_overlap schedule (phase 8c's mesh, m={m}): "
            f"{len(ranges)} labelled exchange ranges, {n_k2} K2 launches, "
            f"{len(entries) - n_k2} exchange copies, {before} K2 launches "
            f"before the first exchange copy [{smi}]")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs a CUDA card")
    import speck_tpu_torch as pt
    from speck_tpu_torch.ops import bitonic, build, contract

    smi = card()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    phase("2")
    # 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path}",
          flush=True)

    phase("3")
    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1 = {}
    for shape in [(512, 8192, "plane", "float32"),
                  (4, 65536, "row", "float32"),
                  (512, 8192, "plane", "float64")]:
        k1[shape] = contract_case(gen, *shape)
        contract_line(*shape, k1[shape], smi)
    k2 = {}
    for shape in [(512, 8192, 1), (512, 8192, 3), (2, 1 << 20, 1)]:
        k2[shape] = sort_case(gen, *shape)
        sort_line(*shape, k2[shape], smi)
    k4_cases, k4 = expand_cases(smi)

    phase("4")
    # 4. the main path at bench config 3's size
    h, ref, t_gen, t_ref = host_and_oracle(pt, CONFIG3)
    cfg = pt.SpgemmConfig()
    A = pt.device_put_csr(h, torch.float32, "cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    plan = pt.plan_spgemm(A, A, cfg)
    # K4's counters between the calls (host integers, no synchronize)
    check_expand("config 3 plan_spgemm", plan, torch.float32, (1,), False)
    C = plan.execute()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    k4_passes = check_expand("config 3 plan_spgemm + execute", plan,
                             torch.float32)
    launches = {"stream_contract": contract.LAUNCHES,
                "row_sort": bitonic.LAUNCHES}
    stream_shapes = dict(bitonic.LAUNCH_SHAPES)
    k1_shapes = dict(contract.LAUNCH_SHAPES)
    check(contract.RUNS_LAUNCHES == 0, "the stream path launched K3")
    lo = plan.stream.layout
    print(f"config 3: m={h.rows} nnz(A)={h.nnz} generated in {t_gen:.2f} s, "
          f"oracle {t_ref:.2f} s; layout W={lo.W} G={lo.G} "
          f"chunks={lo.n_chunks} total_q={lo.total_q} n_wide={lo.n_wide} "
          f"r_wide={lo.r_wide} fused={plan.stream.fused} "
          f"finish_classes={len(plan.stream.finish['classes'] or [])} "
          f"ladder_levels={plan.stream.finish['ladder_levels']}; "
          f"launches {launches}; K4 one launch a chunk in {k4_passes} "
          f"passes", flush=True)
    shape_histogram("the config 3 plan_spgemm + execute", stream_shapes)
    shape_histogram("the config 3 plan_spgemm + execute", k1_shapes, "K1",
                    "rid, dtype")
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
    config3_warm = warm_ms
    check(Cw.nnz == C.nnz, "warm call nnz differs from the cold call")
    products = products_of(h)
    print(f"config 3 A*A f32 [{smi}]: nnz(C)={C.nnz} products={products}"
          f" cold {cold_ms:.1f} ms, warm median of 3 {warm_ms:.1f} ms "
          f"(all {[round(w, 1) for w in warm]}), "
          f"GFLOPS {2 * products / (warm_ms * 1e6):.3f}, "
          f"nnz(C)/s {C.nnz / (warm_ms * 1e-3):.4g}", flush=True)

    # synchronizing calls in one warm call (readbacks and pageable copies)
    print(f"synchronizing calls in one spgemm: "
          f"{sync_count(lambda: pt.spgemm(A, A, cfg))}", flush=True)

    phase("5")
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

    del A, A2, C, C2, Cw, plan
    torch.cuda.empty_cache()

    phase("4b")
    # 4b. the bench's giant row through spgemm
    giant = giant_phase(pt, smi)
    torch.cuda.empty_cache()

    phase("6")
    # 6. K3, and K2 at esc_fixed's sort shapes
    k3 = {}
    for shape in cp.RUNS_SHAPES:
        k3[shape] = contract_runs_case(gen, *shape)
        err, ms, pms = k3[shape]
        print(f"K3 contract_runs {shape}: max_abs_err {err:.3g}, kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bound_ms(cp.k3_bytes(*shape)):.4f} ms [{smi}]", flush=True)
        torch.cuda.empty_cache()
    for shape in [(65536, 4096, 2), (65536, 2048, 1)]:
        k2[shape] = sort_case(gen, *shape)
        sort_line(*shape, k2[shape], smi, " (esc_fixed)")
        torch.cuda.empty_cache()

    phase("7")
    # 7. esc_fixed at bench config 1's size
    esc_launches, esc_shapes, esc_line, esc_warm = esc_phase(pt, smi)
    torch.cuda.empty_cache()

    phase("7c")
    # 7c. the diagonal-plane cells through spgemm
    dia_cells = [dia_cell(pt, smi, *c) for c in DIA_CELLS]
    print(f"config 1 warm call: spgemm (DIA) {dia_cells[0]['warm_ms']:.2f} "
          f"ms, esc_fixed {esc_warm:.2f} ms [{smi}]", flush=True)
    onebee = dia_cells[3]["launches"]
    onebee_k1, onebee_k2 = dia_cells[3]["shapes"]
    shape_histogram("the config 1b plan_spgemm + execute", onebee_k2)
    shape_histogram("the config 1b plan_spgemm + execute", onebee_k1, "K1",
                    "rid, dtype")

    phase("7d")
    # 7d. the general-stream cells through spgemm, then esc_fixed in float64
    gen_cells = [general_cell(pt, smi, *c) for c in GENERAL_CELLS]
    esc64_launches, esc64_shapes, esc64_line, _ = esc_phase(pt, smi,
                                                            "float64")
    torch.cuda.empty_cache()

    phase("7e")
    # 7e. the dense tiles, the accumulator, the transpose: the cells of
    # SLICE_CELLS through spgemm, then config 4 and the Galerkin product
    slice_cells = [slice_cell(pt, smi, *c) for c in SLICE_CELLS]
    print(f"giant row warm call: default config (the sort stream) "
          f"{giant['warm_ms']:.1f} ms, enable_accum=True "
          f"{slice_cells[2]['warm_ms']:.1f} ms "
          f"({giant['warm_ms'] / slice_cells[2]['warm_ms']:.2f}x) [{smi}]",
          flush=True)
    slice_cells.append(galerkin_cell(pt, smi))
    torch.cuda.empty_cache()

    phase("7f")
    # 7f. the row-sharded stream mesh, four shards on one card
    mesh_cells = [mesh_cell(pt, smi, *c) for c in MESH_CELLS]
    mesh = {c["name"]: c for c in mesh_cells}
    ns, ov = mesh["mesh config 3 needset"], mesh["mesh config 3 overlap"]
    check(ov["needset_bytes"] == ns["needset_bytes"],
          f"the overlapped exchange moved {ov['needset_bytes']} bytes, the "
          f"need-set exchange {ns['needset_bytes']}")
    print(f"config 3 warm call [{smi}]: spgemm on the card "
          f"{config3_warm:.1f} ms; the mesh of {MESH_SHARDS} shards on the "
          f"same card (run one after another) needset "
          f"{ns['warm_ms']:.1f} ms, allgather "
          f"{mesh['mesh config 3 allgather']['warm_ms']:.1f} ms, overlapped "
          f"need-set {ov['warm_ms']:.1f} ms (no link: nothing to overlap)",
          flush=True)
    mesh_cells.append(mesh_fixed_cap_cell(pt, smi))
    mesh_cells.append(mesh_dryrun_cell(pt, smi, ns["call"]))
    mesh = {c["name"]: c for c in mesh_cells}

    phase("7g")
    # 7g. the native host library: config 3 through .mtx and back
    native_mtx_cell(pt, smi)

    phase("7h")
    # 7h. the value types and the A/B knobs
    type_cells = [type_cell(pt, smi, *c) for c in TYPE_CELLS]
    esc16 = esc16_cell(pt, smi)
    mesh16_cell(pt, smi)
    scipy_cell(pt, smi)

    phase("7i")
    # 7i. multihost_spgemm across processes: gloo on one card, NCCL with a
    # card a process where there are cards enough
    mh_k1, mh_k2 = multihost_phase(pt, smi, config3_warm)
    torch.cuda.empty_cache()

    phase("7b")
    # 7b. K1 at every shape phases 4, 4b, 7c, 7d, 7e, 7f and 7h launched it
    # at (and the shapes of the probe's table), K2 at every other shape of
    # 4, 4b, 7, 7c, 7d, 7e, 7f and 7h (the widths 3 * 2^k among them)
    k1_all = (set(k1_shapes) | set(giant["k1_shapes"]) | set(cp.SHAPES)
              | set(onebee_k1))
    k2_all = (set(stream_shapes) | set(giant["k2_shapes"]) | set(esc_shapes)
              | set(onebee_k2) | set(esc64_shapes))
    for cell in gen_cells + slice_cells + type_cells + [esc16]:
        k1_all |= set(cell["shapes"][0])
        k2_all |= set(cell["shapes"][1])
    # the mesh's own K1 shapes are timed here by events; phase 9 profiles
    # the rest (each profile is a session of its own, and the mesh's
    # launch-bound shapes would double their number)
    k1_mesh = set(mh_k1) - k1_all
    for cell in mesh_cells:
        k1_mesh |= set(cell["shapes"][0]) - k1_all
        k2_all |= set(cell["shapes"][1])
    k2_all |= set(mh_k2)
    k1_all |= k1_mesh
    for shape in sorted(k1_all):
        if shape not in k1:
            k1[shape] = contract_case(gen, *shape)
            contract_line(*shape, k1[shape], smi, " (main-path shape)")
            torch.cuda.empty_cache()
    for shape in sorted(k2_all):
        if shape not in k2:
            k2[shape] = sort_case(gen, *shape)
            sort_line(*shape, k2[shape], smi, " (main-path shape)")
            torch.cuda.empty_cache()
    # K3 at the fixed-cap mesh's per-shard shape and at esc_fixed's in 16
    # bits
    for shape in sorted((set(mesh["mesh fixed cap config 1"]["shapes"][2])
                         | set(esc16["shapes"][2])) - set(k3)):
        k3[shape] = contract_runs_case(gen, *shape)
        err, ms, pms = k3[shape]
        print(f"K3 contract_runs {shape} (main-path shape): max_abs_err "
              f"{err:.3g}, kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bound_ms(cp.k3_bytes(*shape)):.4f} ms [{smi}]", flush=True)
        torch.cuda.empty_cache()

    phase("8")
    # 8. the gather probes
    probe_launches, probe_cases, probes = probe_phase(gen, smi)
    torch.cuda.empty_cache()

    phase("8b")
    # 8b. the benchmark harness: config 1's headline, config 3's stages
    bench_launches = bench_phase(pt, smi)
    torch.cuda.empty_cache()

    phase("8c")
    # 8c. the nine stage probes at their scripts' sizes
    stage_launches, stage_shapes, overlap, _ = stage_probe_phase(pt, smi)
    shape_histogram("phase 8c", stage_shapes[1])
    shape_histogram("phase 8c", stage_shapes[0], "K1", "rid, dtype")
    # K1 and K2 at every shape 8c launched them at that 7b did not hold
    # against their plain versions (config 2's chunks and wide rows, the
    # 8-shard mesh's); phase 9 leaves these K1 shapes out, as the mesh's
    for shape in sorted(set(stage_shapes[0]) - set(k1)):
        k1[shape] = contract_case(gen, *shape)
        contract_line(*shape, k1[shape], smi, " (phase 8c shape)")
        k1_mesh.add(shape)
        torch.cuda.empty_cache()
    for shape in sorted(set(stage_shapes[1]) - set(k2)):
        k2[shape] = sort_case(gen, *shape)
        sort_line(*shape, k2[shape], smi, " (phase 8c shape)")
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()

    phase("8d")
    # 8d. the seeded conformance sweep, then K1, K2 and K3 at every shape
    # it launched them at that no phase above held against its plain
    # version (one timed call each; a line for each kernel)
    sweep_shapes, sweep_k3 = conformance_phase(smi)
    new = {"K1": 0, "K2": 0, "K3": 0}
    for shape in sorted(set(sweep_shapes[0]) - set(k1)):
        k1[shape] = contract_case(gen, *shape, reps=1)
        k1_mesh.add(shape)
        new["K1"] += 1
    for shape in sorted(set(sweep_shapes[1]) - set(k2)):
        k2[shape] = sort_case(gen, *shape, reps=1)
        new["K2"] += 1
    # K3's shapes apart: phase 9 profiles every shape of k3
    k3_sweep = {}
    for shape in sorted(set(sweep_k3) - set(k3)):
        k3_sweep[shape] = contract_runs_case(gen, *shape)
        new["K3"] += 1
    torch.cuda.empty_cache()
    k1_err = max([v[0] for k, v in k1.items() if k in sweep_shapes[0]]
                 or [0.0])
    print(f"phase 8d: {new} new (kernel, shape, dtype) held against their "
          f"plain versions; max_abs_err K1 {k1_err:.3g}, "
          f"K3 {max([v[0] for v in k3_sweep.values()] or [0]):.3g} "
          f"[{smi}]", flush=True)

    phase("9")
    # 9. the profiled phase, after every CUDA-event time of the phases
    # above: K1's and K3's device times, the giant row's profiled call, then
    # the probes in turns once more, to show what a profiler session before
    # them changes
    k1_dev, k3_dev = {}, {}
    for shape in sorted(set(k1) - k1_mesh):
        rid, col, val = cp.contract_inputs(gen, *shape)
        k1_dev[shape] = cp.kernel_device_ms(
            lambda: contract.stream_contract(rid, col, val, cp.N_COLS))
        device_line(f"K1 stream_contract ({shape[0]}, {shape[1]}) "
                    f"rid={shape[2]} {shape[3]}", k1_dev[shape],
                    cp.k1_bytes(*shape), k1[shape][1], smi)
        del rid, col, val
    for shape in sorted(k3):
        col, val = cp.runs_inputs(gen, *shape)
        k3_dev[shape] = cp.kernel_device_ms(
            lambda: contract.contract_runs(col, val, cp.N_COLS))
        device_line(f"K3 contract_runs {shape}", k3_dev[shape],
                    cp.k3_bytes(*shape), k3[shape][1], smi)
        del col, val
        torch.cuda.empty_cache()
    k4_dev = expand_device(k4_cases, k4, smi)
    phase("9: the giant row, the cells' profiled calls")
    giant_line = giant_profile(pt, giant, smi)
    torch.cuda.empty_cache()
    dia_lines = [dia_profile(pt, cell, smi) for cell in dia_cells]
    # one profiled warm call of the 2^20 graph and of config 3 in float64
    gen_lines = [dia_profile(pt, cell, smi) for cell in gen_cells[:2]]
    torch.cuda.empty_cache()
    # and of the dense-banded and accumulator cells (7e)
    slice_lines = [dia_profile(pt, slice_cells[i], smi) for i in (0, 2)]
    phase("9: the probes")
    probe_turns(probe_cases, probe_launches, smi,
                " (after the profiled phase)")
    # each probe's device time and its library call's, without the host
    # time that their event times hold (medians of 5 profiled calls)
    for name, (_, lib_name, kernel, _, library) in probe_cases.items():
        probes[name]["device_ms"] = statistics.median(
            profile_call(kernel)[1] for _ in range(5))
        lib_dev = statistics.median(profile_call(library)[1]
                                    for _ in range(5))
        print(f"{name}: device {probes[name]['device_ms']:.4f} ms by "
              f"torch.profiler, {lib_name} {lib_dev:.4f} ms [{smi}]",
              flush=True)
    # the mesh last: config 3 under need-set, the dense route, the
    # overlapped exchange, the giant row, the fixed cap (sessions of
    # thousands of kernels, after which a later session of this process
    # may record no device events)
    phase("9: the mesh")
    mesh_lines = [mesh_profile(mesh[n], smi) for n in (
        "mesh config 3 needset", "mesh config 1 dense",
        "mesh config 3 overlap", "mesh giant row needset",
        "mesh fixed cap config 1")]
    # and phase 8c's overlapped mesh step, the last session
    overlap_line = overlap_schedule_line(overlap, smi)

    def k1_by(dname):      # phase 8d's K1 launches of one value type
        return sum(n for k, n in sweep_shapes[0].items() if k[3] == dname)

    def k3_by(dname):      # and its K3 launches
        return sum(n for k, n in sweep_k3.items() if k[2] == dname)

    k1_main = (512, 8192, "plane", "float32")
    k1_main64 = (512, 8192, "plane", "float64")
    k3_main, k3_main64 = (65536, 2048, "float32"), (65536, 2048, "float64")
    # the float64 K1 launches of the main path: phase 7d's float64 cells
    k1_f64_launches = sum(n for cell in gen_cells + mesh_cells
                          for k, n in cell["shapes"][0].items()
                          if k[3] == "float64")
    kernels = [
        {"name": "stream_contract", "route": "cuda",
         "source": "speck_tpu_torch/csrc/stream_contract.cu",
         "replaces": "speck_tpu/ops/pallas_kernels.py:122",
         "launches": (launches["stream_contract"]
                      + bench_launches["stream_contract"]
                      + sum(n for k, n in stage_shapes[0].items()
                            if k[3] == "float32")
                      + giant["launches"]["stream_contract"]
                      + onebee["stream_contract"]
                      + sum(c["launches"]["stream_contract"]
                            for c in slice_cells)
                      + sum(n for c in mesh_cells + type_cells
                            for k, n in c["shapes"][0].items()
                            if k[3] == "float32")
                      + sum(n for k, n in mh_k1.items()
                            if k[3] == "float32")
                      + k1_by("float32")),
         "max_abs_err": max(v[0] for k, v in k1.items()
                            if k[3] == "float32"),
         "ms": k1[k1_main][1], "device_ms": sum(k1_dev[k1_main].values()),
         "plain_ms": k1[k1_main][2],
         "bound_ms": bound_ms(cp.k1_bytes(*k1_main)), "bound_by": "bytes",
         "library_ms": None},
        {"name": "stream_contract (double)", "route": "cuda",
         "source": "speck_tpu_torch/csrc/stream_contract.cu",
         "replaces": "speck_tpu/ops/pallas_kernels.py:122",
         "launches": k1_f64_launches + k1_by("float64"),
         "max_abs_err": max(v[0] for k, v in k1.items()
                            if k[3] == "float64"),
         "ms": k1[k1_main64][1], "device_ms": sum(k1_dev[k1_main64].values()),
         "plain_ms": k1[k1_main64][2],
         "bound_ms": bound_ms(cp.k1_bytes(*k1_main64)), "bound_by": "bytes",
         "library_ms": None},
        {"name": "row_sort", "route": "cuda",
         "source": "speck_tpu_torch/csrc/row_sort.cu",
         "replaces": "speck_tpu/ops/bitonic.py:172",
         "launches": (launches["row_sort"] + bench_launches["row_sort"]
                      + stage_launches["row_sort"]
                      + giant["launches"]["row_sort"]
                      + esc_launches["row_sort"] + onebee["row_sort"]
                      + sum(c["launches"]["row_sort"] for c in gen_cells)
                      + esc64_launches["row_sort"]
                      + sum(c["launches"]["row_sort"] for c in slice_cells)
                      + sum(c["launches"]["row_sort"] for c in mesh_cells)
                      + sum(c["launches"]["row_sort"]
                            for c in type_cells + [esc16])
                      + sum(n for k, n in sweep_shapes[1].items()
                            if not k[1] & (k[1] - 1))
                      + sum(n for k, n in mh_k2.items()
                            if not k[1] & (k[1] - 1))),
         "max_abs_err": max(v[0] for v in k2.values()),
         "ms": k2[(512, 8192, 1)][1], "device_ms": None,
         "plain_ms": k2[(512, 8192, 1)][2],
         "bound_ms": bound_ms(16 * 512 * 8192), "bound_by": "bytes",
         "library_ms": k2[(512, 8192, 1)][3]},
        {"name": "contract_runs", "route": "cuda",
         "source": "speck_tpu_torch/csrc/stream_contract.cu",
         "replaces": "speck_tpu/ops/pallas_kernels.py:153",
         "launches": (esc_launches["contract_runs"]
                      + sum(c["launches"]["contract_runs"]
                            for c in mesh_cells) + k3_by("float32")),
         "max_abs_err": max(v[0] for k, v in {**k3, **k3_sweep}.items()
                            if k[2] == "float32"),
         "ms": k3[k3_main][1], "device_ms": sum(k3_dev[k3_main].values()),
         "plain_ms": k3[k3_main][2],
         "bound_ms": bound_ms(cp.k3_bytes(*k3_main)), "bound_by": "bytes",
         "library_ms": None},
        {"name": "contract_runs (double)", "route": "cuda",
         "source": "speck_tpu_torch/csrc/stream_contract.cu",
         "replaces": "speck_tpu/ops/pallas_kernels.py:153",
         "launches": esc64_launches["contract_runs"] + k3_by("float64"),
         "max_abs_err": max(v[0] for k, v in {**k3, **k3_sweep}.items()
                            if k[2] == "float64"),
         "ms": k3[k3_main64][1],
         "device_ms": sum(k3_dev[k3_main64].values()),
         "plain_ms": k3[k3_main64][2],
         "bound_ms": bound_ms(cp.k3_bytes(*k3_main64)), "bound_by": "bytes",
         "library_ms": None},
    ]
    # the 16-bit variants and K2 at widths that are not powers of two
    # (phase 7h), each at its widest main-path shape
    for dname in ("bfloat16", "float16"):
        kk = max((k for k in k1 if k[3] == dname),
                 key=lambda k: (k[0] * k[1], k))
        kernels.append({
            "name": f"stream_contract ({dname})", "route": "cuda",
            "source": "speck_tpu_torch/csrc/stream_contract.cu",
            "replaces": "speck_tpu/ops/pallas_kernels.py:122",
            "launches": sum(n for c in type_cells
                            for k, n in c["shapes"][0].items()
                            if k[3] == dname) + k1_by(dname),
            "max_abs_err": max(v[0] for k, v in k1.items() if k[3] == dname),
            "ms": k1[kk][1], "device_ms": sum(k1_dev[kk].values()),
            "plain_ms": k1[kk][2], "bound_ms": bound_ms(cp.k1_bytes(*kk)),
            "bound_by": "bytes", "library_ms": None, "shape": list(kk)})
        kr = (65536, 2048, dname)
        kernels.append({
            "name": f"contract_runs ({dname})", "route": "cuda",
            "source": "speck_tpu_torch/csrc/stream_contract.cu",
            "replaces": "speck_tpu/ops/pallas_kernels.py:153",
            "launches": sum(n for k, n in esc16["shapes"][2].items()
                            if k[2] == dname) + k3_by(dname),
            "max_abs_err": max(v[0] for k, v in {**k3, **k3_sweep}.items()
                               if k[2] == dname),
            "ms": k3[kr][1],
            "device_ms": sum(k3_dev[kr].values()), "plain_ms": k3[kr][2],
            "bound_ms": bound_ms(cp.k3_bytes(*kr)), "bound_by": "bytes",
            "library_ms": None})
    kernels += expand_entries(k4_cases, k4, k4_dev)
    odd = {k: n for c in type_cells for k, n in c["shapes"][1].items()
           if k[1] & (k[1] - 1)}
    ko = max(odd, key=lambda k: (k[0] * k[1], k))
    odd_sweep = sum(n for src in (sweep_shapes[1], mh_k2)
                    for k, n in src.items() if k[1] & (k[1] - 1))
    kernels.append({
        "name": "row_sort (width not a power of two, padded)",
        "route": "cuda", "source": "speck_tpu_torch/csrc/row_sort.cu",
        "replaces": "speck_tpu/ops/bitonic.py:172",
        "launches": sum(odd.values()) + odd_sweep,
        "max_abs_err": k2[ko][0],
        "ms": k2[ko][1], "device_ms": None, "plain_ms": k2[ko][2],
        "bound_ms": bound_ms(8 * (1 + ko[2]) * ko[0] * ko[1]),
        "bound_by": "bytes", "library_ms": k2[ko][3], "shape": list(ko)})
    for name, replaces in [
            ("sublane_gather", "scripts/gather_microbench2.py:143"),
            ("run_copy", "scripts/gather_microbench2.py:195 and "
                         "scripts/expand_microbench.py:121")]:
        kernels.append(dict(
            {"name": name, "route": "cuda",
             "source": "speck_tpu_torch/csrc/gather_probes.cu",
             "replaces": replaces, "launches": probe_launches[name]},
            **probes[name]))
    print(giant_line, flush=True)
    print(esc_line, flush=True)
    for cell, line in zip(dia_cells, dia_lines):
        print(cell["line"], flush=True)
        print(line, flush=True)
    for cell in gen_cells:
        print(cell["line"], flush=True)
    for line in gen_lines:
        print(line, flush=True)
    print(esc64_line, flush=True)
    for cell in slice_cells:
        print(cell["line"], flush=True)
    for line in slice_lines:
        print(line, flush=True)
    for cell in mesh_cells:
        print(cell["line"], flush=True)
    for line in mesh_lines:
        print(line, flush=True)
    for cell in type_cells:
        print(cell["line"], flush=True)
    print(overlap_line, flush=True)
    phase("end")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
