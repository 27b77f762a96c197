"""The row sort: each row of an int32 key sorted ascending, with up to
three 32-bit payloads permuted the same way.

``row_sort`` replaces ``speck_tpu``'s Pallas kernel
``bitonic.bitonic_sort_pairs_pallas`` and, for rows of 2^20 and wider,
``bitonic.blocked_sort_pairs``. On a CUDA tensor it launches the
hand-written bitonic network ``csrc/row_sort.cu`` (shared-memory tiles,
global-memory passes for strides wider than a tile). On a CPU tensor it
runs ``sort_plain``: a stable ``torch.sort`` and a gather of the payloads.

The network is not stable. Every use in the stream is single-key with a
key that orders the slots the result depends on: the packed
(row, column) key, the unique compaction rank, or the column of one row,
whose equal keys hold duplicates that are summed next. Structure is
therefore exact and sums differ only in order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import build

# launches of the CUDA kernel in this process (the plain version does not
# count)
LAUNCHES = 0

MAX_PAYLOADS = 3


def sort_plain(key, payloads):
    key_s, perm = torch.sort(key, dim=1, stable=True)
    return key_s, tuple(torch.gather(p, 1, perm) for p in payloads)


def _check(key, payloads):
    if key.dim() != 2 or key.dtype != torch.int32 or not key.is_contiguous():
        raise ValueError("row_sort: key must be a contiguous (R, W) int32 "
                         "tensor")
    W = key.shape[1]
    if W < 1 or W & (W - 1):
        raise ValueError(f"row_sort: width {W} is not a power of two")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"row_sort: at most {MAX_PAYLOADS} payloads")
    for p in payloads:
        if (p.shape != key.shape or p.dtype not in (torch.int32,
                                                    torch.float32)
                or not p.is_contiguous() or p.device != key.device):
            raise ValueError("row_sort: payloads must be contiguous 32-bit "
                             "tensors shaped like the key")


def row_sort(key: torch.Tensor, payloads: Sequence[torch.Tensor] = ()
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Sort each row of ``key`` ascending; permute ``payloads`` alike."""
    payloads = tuple(payloads)
    _check(key, payloads)
    if key.device.type == "cpu":
        return sort_plain(key, payloads)
    if key.device.type != "cuda":
        raise ValueError(f"row_sort: unsupported device {key.device}")
    R, W = key.shape
    key_out = torch.empty_like(key)
    outs = tuple(torch.empty_like(p) for p in payloads)
    if R == 0:
        return key_out, outs
    ins = [p.view(torch.int32).data_ptr() for p in payloads]
    ptr_out = [p.view(torch.int32).data_ptr() for p in outs]
    ins += [None] * (MAX_PAYLOADS - len(ins))
    ptr_out += [None] * (MAX_PAYLOADS - len(ptr_out))
    lib = build.library()
    err = lib.speck_row_sort(
        key.data_ptr(), key_out.data_ptr(), *ins, *ptr_out, len(payloads),
        R, W, torch.cuda.current_stream(key.device).cuda_stream)
    build.check(err, "row_sort launch")
    global LAUNCHES
    LAUNCHES += 1
    return key_out, outs
