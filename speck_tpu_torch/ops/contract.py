"""The stream contract: run-last mask and segmented run sums of
(rid, col)-sorted rectangle rows.

``stream_contract`` replaces ``speck_tpu``'s Pallas kernel
``pallas_kernels.stream_contract_runs``. On a CUDA tensor it launches the
hand-written kernel ``csrc/stream_contract.cu``; on a CPU tensor it runs
``contract_plain``, the torch form of ``stream._contract_rect`` in the same
Hillis-Steele doubling order, so on the CPU it is bit-identical to both
JAX forms. The kernel sums each run in another order, so its sums agree
with the plain version at tolerance; the mask agrees exactly.

``rid`` is either a full (R, W) plane or a per-row constant broadcast to
(R, W) (stride 0 along W: the merge levels and the wide finish), which the
kernel reads without materializing.
"""

from __future__ import annotations

import torch

from . import build

# launches of the CUDA kernel in this process (the plain version does not
# count)
LAUNCHES = 0


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
    last = nxt_change & (col < n_cols)
    v, f = val, changed
    d = 1
    while d < W:
        v_s = torch.cat([torch.zeros_like(v[:, :d]), v[:, :-d]], dim=1)
        f_s = torch.cat([torch.ones_like(f[:, :d]), f[:, :-d]], dim=1)
        v = torch.where(f, v, v + v_s)
        f = f | f_s
        d <<= 1
    return last, v


def _check(rid, col, val):
    if col.dim() != 2 or col.dtype != torch.int32 or not col.is_contiguous():
        raise ValueError("stream_contract: col must be a contiguous (R, W) "
                         "int32 tensor")
    R, W = col.shape
    if W < 1:
        raise ValueError("stream_contract: rows must be at least 1 wide")
    if (val.shape != col.shape or val.dtype != torch.float32
            or not val.is_contiguous()):
        raise ValueError("stream_contract: val must be a contiguous (R, W) "
                         "float32 tensor")
    if rid.shape != col.shape or rid.dtype != torch.int32:
        raise ValueError("stream_contract: rid must be an (R, W) int32 "
                         "tensor")
    if rid.stride(1) not in (0, 1):
        raise ValueError("stream_contract: rid must be contiguous along W "
                         "or a per-row broadcast")
    if not (rid.device == col.device == val.device):
        raise ValueError("stream_contract: tensors on different devices")


def stream_contract(rid, col, val, n_cols: int):
    """(last bool (R, W), run_sum float32 (R, W)) of sorted rows."""
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
    lib = build.library()
    err = lib.speck_stream_contract(
        rid.data_ptr(), rid.stride(0), rid.stride(1), col.data_ptr(),
        val.data_ptr(), last.data_ptr(), sums.data_ptr(), R, W, int(n_cols),
        torch.cuda.current_stream(col.device).cuda_stream)
    build.check(err, "stream_contract launch")
    global LAUNCHES
    LAUNCHES += 1
    return last, sums
