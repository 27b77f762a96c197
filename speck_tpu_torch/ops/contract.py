"""The contracts: run-last mask and segmented run sums of sorted rectangle
rows, with a (rid, col) run key (the stream, K1) or a column key (the
ESC rectangle, K3).

``stream_contract`` replaces ``speck_tpu``'s Pallas kernel
``pallas_kernels.stream_contract_runs``. On a CUDA tensor it launches the
hand-written kernel ``csrc/stream_contract.cu``: a flat segmented scan over
the R*W slots in tiles of ``TILE``, one CTA a tile, the carry passed
between tiles by a deterministic decoupled look-back. On a CPU tensor it
runs ``contract_plain``, the torch form of ``stream._contract_rect`` in the
same Hillis-Steele doubling order, so on the CPU it is bit-identical to
both JAX forms. The kernel sums each run in another order, so its sums
agree with the plain version at tolerance; the mask agrees exactly, and
two launches on the same input agree bit for bit.

``rid`` is either a full (R, W) plane or a per-row constant broadcast to
(R, W) (stride 0 along W: the merge levels and the wide finish). The
kernel never reads a per-row rid: a row head starts a run anyway.

``contract_runs`` replaces the Pallas kernel ``pallas_kernels.contract_runs``
(the same function as ``esc._run_boundaries`` + ``esc._run_sums``). On a
CUDA tensor it launches K3, the no-rid variant of the same CUDA kernel; on a
CPU tensor it runs ``contract_runs_plain``, bit-identical to the JAX forms.
Unlike the Pallas kernel it takes any width and any row count.

Both take float16, bfloat16, float32 or float64 values. A float64 plane
launches the kernels' ``double`` variant (the reference's ``double``
instantiation), whose look-back publishes each tile's aggregate and prefix
in separate slots of a three-word record (``_scratch`` sizes it). A 16-bit
plane launches the ``__half`` or ``__nv_bfloat16`` variant: it loads 16
bits a value, sums in float (float's look-back record) and stores 16 bits
once. The plain versions do the same: a 16-bit plane is summed in float32
and rounded once (``_sum_dtype``), which is more accurate than the
reference's 16-bit doubling sums; both lie within the 16-bit bound of
``utils/compare.bound16``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import build
from .bitonic import count_live

# launches of the CUDA kernels in this process (the plain versions do not
# count): K1 (stream_contract), in all and by (R, W, "plane" or "row",
# value dtype), and K3 (contract_runs), in all and by (R, W, value dtype);
# and by K1's key, [launches, live slots] of the K1 launches whose caller
# gave the live slots (``live``, a stream chunk's apportioned as
# ``bitonic.LAUNCH_LIVE``'s)
LAUNCHES = 0
LAUNCH_SHAPES: Dict[Tuple[int, int, str, str], int] = {}
LAUNCH_LIVE: Dict[Tuple[int, int, str, str], List[int]] = {}
RUNS_LAUNCHES = 0
RUNS_LAUNCH_SHAPES: Dict[Tuple[int, int, str], int] = {}

VALUE_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
# the C entry points' suffix by value dtype
_SUFFIX = {torch.float32: "", torch.float64: "_f64", torch.bfloat16: "_bf16",
           torch.float16: "_f16"}

# slots one CTA takes (kTile in csrc/stream_contract.cu)
TILE = 4096


def _sum_dtype(dtype):
    """The type a contract sums ``dtype`` values in: float32 for the
    16-bit types, else the type itself."""
    return torch.float32 if dtype.itemsize == 2 else dtype


def run_sums(val, first):
    """Segmented inclusive sums restarting at every ``first`` slot, by
    Hillis-Steele doubling in the JAX forms' order (16-bit values summed
    in float32 and rounded once)."""
    W = val.shape[1]
    v, f = val.to(_sum_dtype(val.dtype)), first
    d = 1
    while d < W:
        v_s = torch.cat([torch.zeros_like(v[:, :d]), v[:, :-d]], dim=1)
        f_s = torch.cat([torch.ones_like(f[:, :d]), f[:, :-d]], dim=1)
        v = torch.where(f, v, v + v_s)
        f = f | f_s
        d <<= 1
    return v.to(val.dtype)


def run_boundaries(col, n_cols: int):
    """(first, last) of equal-column runs of a column-sorted rectangle;
    sentinel ``n_cols`` runs are excluded from ``last``."""
    R = col.shape[0]
    prev = torch.cat([torch.full((R, 1), -1, dtype=col.dtype,
                                 device=col.device), col[:, :-1]], dim=1)
    nxt = torch.cat([col[:, 1:], torch.full((R, 1), -2, dtype=col.dtype,
                                            device=col.device)], dim=1)
    return col != prev, (col != nxt) & (col < n_cols)


def contract_runs_plain(col, val, n_cols: int):
    """(last, run_sum) of column-sorted rows: ``run_boundaries`` and
    ``run_sums``."""
    first, last = run_boundaries(col, n_cols)
    return last, run_sums(val, first)


def contract_plain(rid, col, val, n_cols: int):
    """(last, run_sum): last marks the final slot of each live run (the
    next slot differs in rid or col, and col < n_cols); run_sum is the
    segmented inclusive sum that restarts at every run start."""
    G, W = col.shape
    dev = col.device
    changed = torch.cat(
        [torch.ones((G, 1), dtype=torch.bool, device=dev),
         (col[:, 1:] != col[:, :-1]) | (rid[:, 1:] != rid[:, :-1])], dim=1)
    nxt_change = torch.cat(
        [changed[:, 1:], torch.ones((G, 1), dtype=torch.bool, device=dev)],
        dim=1)
    return nxt_change & (col < n_cols), run_sums(val, changed)


def _check_col_val(col, val, what):
    if col.dim() != 2 or col.dtype != torch.int32 or not col.is_contiguous():
        raise ValueError(f"{what}: col must be a contiguous (R, W) int32 "
                         "tensor")
    if col.shape[1] < 1:
        raise ValueError(f"{what}: rows must be at least 1 wide")
    if (val.shape != col.shape or val.dtype not in VALUE_DTYPES
            or not val.is_contiguous()):
        raise ValueError(f"{what}: val must be a contiguous (R, W) float16, "
                         "bfloat16, float32 or float64 tensor")
    if val.device != col.device:
        raise ValueError(f"{what}: tensors on different devices")


def _check(rid, col, val):
    _check_col_val(col, val, "stream_contract")
    if rid.shape != col.shape or rid.dtype != torch.int32:
        raise ValueError("stream_contract: rid must be an (R, W) int32 "
                         "tensor")
    if rid.stride(1) not in (0, 1):
        raise ValueError("stream_contract: rid must be contiguous along W "
                         "or a per-row broadcast")
    if not (rid.device == col.device == val.device):
        raise ValueError("stream_contract: tensors on different devices")


def _check_kernel_inputs(what, *planes):
    """The kernel's 16-byte loads need contiguous, 16-byte aligned planes
    (as the allocator gives them); raise for any other."""
    for x in planes:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: on the card every (R, W) plane must "
                             "be contiguous and 16-byte aligned")


def _scratch(col, dtype=torch.float32):
    """The kernel's scratch for col's (R, W), which the launcher clears:
    the tile counter and a tile's status (one word for float sums, of
    float32 and 16-bit values, a record of three for float64); None where
    W divides the tile, since every tile then starts at a row head and
    needs no carry."""
    R, W = col.shape
    if TILE % W == 0:
        return None
    words = 3 if dtype == torch.float64 else 1
    return torch.empty(1 + words * -(-R * W // TILE), dtype=torch.int64,
                       device=col.device)


def _dtype_name(val) -> str:
    return str(val.dtype).replace("torch.", "")


def stream_contract(rid, col, val, n_cols: int, live: Optional[int] = None):
    """(last bool (R, W), run_sum (R, W) in val's dtype) of sorted rows.
    ``live``: the slots that hold a product or a real entry, where the
    caller knows them (``LAUNCH_LIVE``)."""
    _check(rid, col, val)
    if col.device.type == "cpu":
        return contract_plain(rid, col, val, n_cols)
    if col.device.type != "cuda":
        raise ValueError(f"stream_contract: unsupported device {col.device}")
    R, W = col.shape
    last = torch.empty((R, W), dtype=torch.bool, device=col.device)
    sums = torch.empty_like(val)
    if R == 0:
        return last, sums
    per_row = rid.stride(1) == 0
    _check_kernel_inputs("stream_contract", col, val,
                         *(() if per_row else (rid,)))
    scratch = _scratch(col, val.dtype)
    lib = build.library()
    fn = getattr(lib, "speck_stream_contract" + _SUFFIX[val.dtype])
    # the launch runs on the tensors' card (the current device is the
    # launcher's, which a mesh over several cards does not set)
    with torch.cuda.device(col.device):
        err = fn(
            None if per_row else rid.data_ptr(), col.data_ptr(),
            val.data_ptr(), last.data_ptr(), sums.data_ptr(), R, W,
            int(n_cols), None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(col.device).cuda_stream)
    build.check(err, "stream_contract launch")
    global LAUNCHES
    LAUNCHES += 1
    shape = (R, W, "row" if per_row else "plane", _dtype_name(val))
    LAUNCH_SHAPES[shape] = LAUNCH_SHAPES.get(shape, 0) + 1
    count_live(LAUNCH_LIVE, shape, live, R * W)
    return last, sums


def contract_runs(col, val, n_cols: int):
    """(last bool (R, W), run_sum (R, W) in val's dtype) of column-sorted
    rows."""
    _check_col_val(col, val, "contract_runs")
    if col.device.type == "cpu":
        return contract_runs_plain(col, val, n_cols)
    if col.device.type != "cuda":
        raise ValueError(f"contract_runs: unsupported device {col.device}")
    R, W = col.shape
    last = torch.empty((R, W), dtype=torch.bool, device=col.device)
    sums = torch.empty_like(val)
    if R == 0:
        return last, sums
    _check_kernel_inputs("contract_runs", col, val)
    scratch = _scratch(col, val.dtype)
    lib = build.library()
    fn = getattr(lib, "speck_contract_runs" + _SUFFIX[val.dtype])
    with torch.cuda.device(col.device):
        err = fn(
            col.data_ptr(), val.data_ptr(), last.data_ptr(),
            sums.data_ptr(), R, W, int(n_cols),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(col.device).cuda_stream)
    build.check(err, "contract_runs launch")
    global RUNS_LAUNCHES
    RUNS_LAUNCHES += 1
    shape = (R, W, _dtype_name(val))
    RUNS_LAUNCH_SHAPES[shape] = RUNS_LAUNCH_SHAPES.get(shape, 0) + 1
    return last, sums
