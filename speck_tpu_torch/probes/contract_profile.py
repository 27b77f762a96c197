"""The contract kernels by shape on the card (``ops/contract``):

    python -m speck_tpu_torch.probes.contract_profile

K1 (``stream_contract``) at every shape the two spgemm paths launch it at
(bench config 3 and the giant row; ``SHAPES``, float32, and the shapes of
config 3 in float64) and K3 (``contract_runs``) at esc_fixed's in both
dtypes, on sorted random inputs (``contract_inputs``,
``runs_inputs``), each checked against its plain version, then timed three
ways, each over every shape before the next: one wrapper call between CUDA
events (median and extremes of REPS calls); the host time a wrapper call
takes (REPS calls back to back, no synchronize between); and the call's
device time from ``torch.profiler`` (the kernel and the clear of its
scratch, medians over REPS calls, ``kernel_device_ms``), last, so that no
event time follows a profiler session. Beside them the bound: the bytes
each input is read and each output written once, at 3.35 TB/s. The
module uses only the wrappers' names and ``timing.card``/``cuda_ms_turns``,
so the same file run inside an older tree of the package times that tree's
kernels (its float64 shapes need a tree whose contracts take float64).
"""

from __future__ import annotations

import statistics
import time

import torch

HBM_BYTES_PER_MS = 3.35e12 / 1e3
N_COLS = 4096
REPS = 21

# K1: (R, W, rid kind, value dtype) with the launches on the main paths
# (default SpgemmConfig): bench config 3 and the bench's giant row;
# (4, 65536, row) is the per-row case of the first design's measurement;
# config 3's chunks and a giant finish in float64
SHAPES = [(512, 8192, "plane", "float32"), (136, 8192, "plane", "float32"),
          (8, 16384, "row", "float32"), (1, 32768, "row", "float32"),
          (64, 65536, "plane", "float32"), (16, 65536, "plane", "float32"),
          (1, 1 << 23, "row", "float32"), (4, 65536, "row", "float32"),
          (512, 8192, "plane", "float64"), (136, 8192, "plane", "float64"),
          (1, 1 << 23, "row", "float64")]
RUNS_SHAPES = [(65536, 2048, "float32"), (64, 256, "float32"),
               (65536, 2048, "float64")]


# bytes a value of each type
VALUE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def k1_bytes(R: int, W: int, kind: str, dtype: str = "float32") -> int:
    """Device bytes of one K1 call: rid (a plane only), col and val read,
    last and sums written: 17 and 13 bytes a slot in float32, 25 and 21
    in float64, 13 and 9 in the 16-bit types."""
    vb = VALUE_BYTES[dtype]
    return ((4 if kind == "plane" else 0) + 4 + 2 * vb + 1) * R * W


def k3_bytes(R: int, W: int, dtype: str = "float32") -> int:
    """Device bytes of one K3 call: col and val read, last and sums
    written (13 bytes a slot in float32, 21 in float64, 9 in 16 bits)."""
    return (5 + 2 * VALUE_BYTES[dtype]) * R * W


def contract_inputs(gen, R: int, W: int, kind: str, dtype: str = "float32",
                    n_cols: int = N_COLS):
    """(rid, col, val) on the card, rows sorted by (rid, col), the last
    eighth of each row dead (col = n_cols), values in ``dtype``. "plane":
    rid and col from one sorted random key (short runs); "row": a per-row
    rid broadcast along W and sorted columns below n_cols (runs of about
    W / n_cols)."""
    dev = torch.device("cuda")
    if kind == "row":
        col = torch.sort(torch.randint(0, n_cols, (R, W), generator=gen,
                                       device=dev, dtype=torch.int32),
                         1).values
        rid = (torch.arange(R, dtype=torch.int32, device=dev) + 5)[:, None]
        rid = rid.expand(R, W)
    else:
        key = torch.sort(torch.randint(0, 1 << 22, (R, W), generator=gen,
                                       device=dev, dtype=torch.int32),
                         1).values
        rid, col = key >> 12, key & (n_cols - 1)
    dead = torch.arange(W, device=dev)[None, :] >= W - W // 8
    col = torch.where(dead, n_cols, col).to(torch.int32).contiguous()
    if kind != "row":
        rid = torch.where(dead, rid[:, :1], rid).to(torch.int32).contiguous()
    return rid, col, torch.randn((R, W), generator=gen, device=dev,
                                 dtype=getattr(torch, dtype))


def runs_inputs(gen, R: int, W: int, dtype: str = "float32",
                n_cols: int = N_COLS):
    """(col, val) on the card for K3: sorted columns, the last eighth
    dead, values in ``dtype``."""
    dev = torch.device("cuda")
    col = torch.sort(torch.randint(0, n_cols, (R, W), generator=gen,
                                   device=dev, dtype=torch.int32), 1).values
    dead = torch.arange(W, device=dev)[None, :] >= W - W // 8
    col = torch.where(dead, n_cols, col).to(torch.int32).contiguous()
    return col, torch.randn((R, W), generator=gen, device=dev,
                            dtype=getattr(torch, dtype))


# unit roundoff and half the smallest subnormal of the 16-bit types
HALF_ROUNDING = {torch.bfloat16: (2.0 ** -8, 2.0 ** -134),
                 torch.float16: (2.0 ** -11, 2.0 ** -25)}


def sums_close(got, want, mag) -> bool:
    """Sums taken in another order: within 1e-6 + 1e-5 of the run prefix's
    sum of magnitudes in float32, 1e-12 of it in float64; 16-bit sums are
    taken in float and rounded once by the kernel and the plain version
    alike, so within that float32 bound plus a rounding on each side
    (2 u of the magnitude, and the underflow term)."""
    if got.dtype in HALF_ROUNDING:
        u, eta = HALF_ROUNDING[got.dtype]
        got, want, mag = got.float(), want.float(), mag.float()
        return bool(((got - want).abs()
                     <= 1e-6 + (1e-5 + 2 * u) * mag + 2 * eta).all())
    if got.dtype == torch.float64:
        return bool(((got - want).abs() <= 1e-300 + 1e-12 * mag).all())
    return bool(((got - want).abs() <= 1e-6 + 1e-5 * mag).all())


# the kernels one K1 or K3 call launches: the contract itself and the clear
# of its scratch (none where W divides the tile, nor in older trees)
KERNELS = ("contract_kernel", "contract_scratch_clear")


def kernel_device_ms(fn, reps: int = REPS) -> dict:
    """Device time (ms) of one call of fn by ``torch.profiler``, after one
    warm-up call, for each of ``KERNELS`` (a kernel name holds it): the
    median over reps calls, 0.0 where fn launched no such kernel. The sum
    is the call's device time, without its wrapper's host time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {n: [] for n in KERNELS}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n in KERNELS:
                if n in e.name:
                    times[n].append(e.time_range.elapsed_us() / 1e3)
    if not times[KERNELS[0]]:
        raise RuntimeError(f"no {KERNELS[0]} kernel in the profile")
    return {n: statistics.median(t) if t else 0.0 for n, t in times.items()}


def host_ms(fn, reps: int = REPS) -> float:
    """Host time of one call of fn: reps calls back to back, then one
    synchronize outside the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def main():
    from speck_tpu_torch.ops import contract
    from speck_tpu_torch.probes.timing import card, cuda_ms_turns

    if not torch.cuda.is_available():
        raise RuntimeError("contract_profile: no CUDA card (the profile "
                           "times the card only)")
    smi = card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = []  # (what, fn, bytes), each checked against its plain version
    for R, W, kind, dtype in SHAPES:
        rid, col, val = contract_inputs(gen, R, W, kind, dtype)
        last_k, sum_k = contract.stream_contract(rid, col, val, N_COLS)
        last_p, sum_p = contract.contract_plain(rid, col, val, N_COLS)
        mag = contract.contract_plain(rid, col, val.abs(), N_COLS)[1]
        if not (torch.equal(last_k, last_p)
                and sums_close(sum_k, sum_p, mag)):
            raise RuntimeError(f"K1 differs from contract_plain at "
                               f"{(R, W, kind, dtype)}")
        cases.append((f"K1 stream_contract ({R}, {W}) rid={kind} {dtype}",
                      lambda a=(rid, col, val): contract.stream_contract(
                          *a, N_COLS), k1_bytes(R, W, kind, dtype)))
    for R, W, dtype in RUNS_SHAPES:
        col, val = runs_inputs(gen, R, W, dtype)
        last_k, sum_k = contract.contract_runs(col, val, N_COLS)
        last_p, sum_p = contract.contract_runs_plain(col, val, N_COLS)
        mag = contract.contract_runs_plain(col, val.abs(), N_COLS)[1]
        if not (torch.equal(last_k, last_p)
                and sums_close(sum_k, sum_p, mag)):
            raise RuntimeError(f"K3 differs from contract_runs_plain at "
                               f"{(R, W, dtype)}")
        cases.append((f"K3 contract_runs ({R}, {W}) {dtype}",
                      lambda a=(col, val): contract.contract_runs(*a, N_COLS),
                      k3_bytes(R, W, dtype)))
    del last_k, sum_k, last_p, sum_p, mag
    torch.cuda.empty_cache()
    # events and host times first, then every profiler session: a CUDA-event
    # time taken after a profiler session may read differently
    ev = [cuda_ms_turns({"kernel": fn}, REPS)["kernel"] for _, fn, _ in cases]
    host = [host_ms(fn) for _, fn, _ in cases]
    dev = [kernel_device_ms(fn) for _, fn, _ in cases]
    for (what, _, nbytes), k, h, d in zip(cases, ev, host, dev):
        print(f"{what}: kernel {statistics.median(k):.4f} ms (min "
              f"{min(k):.4f}, max {max(k):.4f}) between events, device "
              f"{sum(d.values()):.4f} ms (kernel {d[KERNELS[0]]:.4f}, "
              f"scratch clear {d[KERNELS[1]]:.4f}), host {h:.4f} ms a call, "
              f"bound {nbytes / HBM_BYTES_PER_MS:.4f} ms; medians of {REPS} "
              f"[{smi}]", flush=True)


if __name__ == "__main__":
    main()
