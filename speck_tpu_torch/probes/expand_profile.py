"""The expand kernel K4 (``ops/expand.stream_expand``) on the card:

    python -m speck_tpu_torch.probes.expand_profile

At the chunk shape the cells launch, (512, 8192), in the three value
types they run, on chunks as the planner lays them out (``stream_plan``:
``plan_spgemm`` with the stream route forced; ``expand_args``: a chunk's
operands as the numeric pass takes them from the plan): bench config 3's
power-law graph A·A in float32 (the packed record) and in bfloat16, and
A·A of a 27-point stencil on a 60^3 grid in float64, whose 5.8M records
are more than a chunk's window holds, as hpcg27's are (``CASES``). The
middle chunk of each, expanded by K4 and by ``expand_plain`` on the card:
all three planes equal bit for bit and two launches equal (``case``);
then, over every case before the next way, K4 and the plain version in
turns between CUDA events (``event_ms``, medians of REPS) and K4's device
time by ``torch.profiler`` (``kernel_device_ms``, the median of REPS
launches), beside the bound (``k4_bytes``: the planes written once and
each live product's B entry read once, at 3.35 TB/s). ``chip_smoke.py``
runs the same cases through the same functions.
"""

from __future__ import annotations

import statistics
from typing import NamedTuple

import torch

from ..ops.device_csr import device_put_csr
from ..ops.expand import Unpacked, expand_plain, stream_expand
from ..ops.spgemm import _stream_operands, plan_spgemm
from ..utils import generators
from ..utils.config import SpgemmConfig

HBM_BYTES_PER_MS = 3.35e12 / 1e3
REPS = 21
# the cells' chunk: (G, W)
SHAPE = (512, 8192)
# every route but the stream off, so that every row rides the stream
STREAM_ONLY = dict(enable_direct=False, enable_dense=False,
                   enable_accum=False, enable_dia=False, enable_sdia=False,
                   dia_rows=False)
# (value type, generator call): config 3's graph and a stencil past a
# chunk's window of records
CASES = [("float32", ("make_powerlaw", (262144, 12, 2.2, 7))),
         ("float64", ("make_stencil27", (60, 19))),
         ("bfloat16", ("make_powerlaw", (262144, 12, 2.2, 7)))]
KERNEL = "stream_expand_kernel"


class Case(NamedTuple):
    """One chunk of a plan, checked on the card: its label, the arguments
    of ``stream_expand``/``expand_plain``, K4's bytes and the largest
    difference of the values K4 and the plain version gave."""

    label: str
    args: tuple
    nbytes: int
    max_abs_err: float


def stream_plan(A, B=None, **cfg):
    """``plan_spgemm(A, B)`` (B defaults to A) under ``STREAM_ONLY`` and
    the keywords given; raises unless the plan has a stream."""
    plan = plan_spgemm(A, A if B is None else B,
                       SpgemmConfig(**dict(STREAM_ONLY, **cfg)))
    if plan.stream is None or plan.stream.layout.n_chunks == 0:
        raise RuntimeError("expand_profile: the plan has no stream chunk")
    return plan


def expand_args(plan, c: int, rec=None):
    """The positional arguments of ``stream_expand``/``expand_plain`` for
    chunk c of the plan's stream, as ``stream.chunk_expand`` gives them
    (``rec``: the chunk records with their operands bound, the plan's own
    by default)."""
    if rec is None:
        rec = _stream_operands(plan.A, plan.B, plan.stream.rec)
    CP = rec.G * rec.W
    return (rec.e, rec.p0, rec.su, rec.sa, rec.pend, rec.b, c * CP,
            rec.sid_bases[c], rec.rows(c), rec.W, rec.n_cols, CP)


def bits(x: torch.Tensor) -> torch.Tensor:
    """A plane's bits, for comparisons bit for bit."""
    return x.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[x.element_size()])


def planes_equal(got, want) -> bool:
    """(rid, col, val) equal bit for bit, types included."""
    return all(g.dtype == w.dtype and g.shape == w.shape
               and torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def k4_bytes(G: int, W: int, b, live: int) -> int:
    """Device bytes of one K4 launch: rid, col and val written once (12
    bytes a slot in float32, 16 in float64, 10 in 16 bits) and each live
    product's B entry read once (8 packed; 4 + the value's apart)."""
    if isinstance(b, Unpacked):
        out = torch.promote_types(b.a_data.dtype, b.b_data.dtype)
        per_live = 4 + b.b_data.element_size()
    else:
        out, per_live = torch.float32, 8
    return (8 + out.itemsize) * G * W + per_live * live


def check_case(args):
    """K4 against expand_plain on the card, bit for bit, and two launches
    bit-identical; returns (the chunk's live products, the largest
    difference of the two val planes)."""
    k = stream_expand(*args)
    k2 = stream_expand(*args)
    p = expand_plain(*args)
    torch.cuda.synchronize()
    if not planes_equal(k, p):
        diff = [int((bits(a) != bits(b)).sum()) for a, b in zip(k, p)]
        raise RuntimeError(f"K4 differs from expand_plain: {diff} slots "
                           "(rid, col, val)")
    if not planes_equal(k, k2):
        raise RuntimeError("two K4 launches differ")
    err = float((k[2].double() - p[2].double()).abs().max())
    return int((k[1] < args[10]).sum()), err


def case(value: str, gen_call, device="cuda") -> Case:
    """The middle chunk of A·A of ``gen_call``'s matrix in ``value``,
    planned on the stream at SHAPE, checked (``check_case``)."""
    fn, fn_args = gen_call
    h = getattr(generators, fn)(*fn_args)
    plan = stream_plan(device_put_csr(h, getattr(torch, value), device))
    lo = plan.stream.layout
    if (lo.G, lo.W) != SHAPE:
        raise RuntimeError(f"expand_profile: {fn} planned (G, W) = "
                           f"({lo.G}, {lo.W}), not {SHAPE}")
    args = expand_args(plan, lo.n_chunks // 2)
    live, err = check_case(args)
    kind = "unpacked" if isinstance(args[5], Unpacked) else "packed"
    nnz_a = args[2].shape[0]
    label = (f"K4 stream_expand {SHAPE} {kind} {value} ({fn} A*A, chunk "
             f"{lo.n_chunks // 2} of {lo.n_chunks}, records {nnz_a}, "
             f"window {min(nnz_a, lo.G * lo.W + 2)}, live {live})")
    return Case(label, args, k4_bytes(*SHAPE, args[5], live), err)


def cases(device="cuda"):
    """[Case] of the profile, one a value type of CASES."""
    return [case(value, gen_call, device) for value, gen_call in CASES]


def event_ms(args, reps: int = REPS):
    """K4 and expand_plain on one chunk in turns between CUDA events:
    (K4 ms, plain ms), medians of reps."""
    from .timing import cuda_ms_turns

    t = cuda_ms_turns({"kernel": lambda: stream_expand(*args),
                       "plain": lambda: expand_plain(*args)}, reps)
    return statistics.median(t["kernel"]), statistics.median(t["plain"])


def kernel_device_ms(args, reps: int = REPS) -> float:
    """Device time (ms) of K4 on one chunk by ``torch.profiler``: the
    median over reps launches, after one warm-up launch."""
    from torch.profiler import ProfilerActivity, profile

    stream_expand(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            stream_expand(*args)
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and KERNEL in e.name]
    if not times:
        raise RuntimeError(f"no {KERNEL} in the profile")
    return statistics.median(times)


def main():
    from .timing import card

    if not torch.cuda.is_available():
        raise RuntimeError("expand_profile: no CUDA card (the profile times "
                           "the card only)")
    smi = card()
    todo = cases()
    # events first, then every profiler session
    ev = [event_ms(c.args) for c in todo]
    dev = [kernel_device_ms(c.args) for c in todo]
    for c, (k, p), d in zip(todo, ev, dev):
        bms = c.nbytes / HBM_BYTES_PER_MS
        print(f"{c.label}: device {d:.4f} ms ({d / bms:.2f}x the bound "
              f"{bms:.4f} ms), events {k:.4f} ms, plain {p:.4f} ms; medians "
              f"of {REPS}, bit-equal to the plain version [{smi}]",
              flush=True)


if __name__ == "__main__":
    main()
