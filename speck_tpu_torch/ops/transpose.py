"""Device CSR transpose (torch port of ``speck_tpu/ops/transpose.py``).

Aᵀ's order is A's nonzeros by ascending (column, row). CSR's flat order is
already row-ascending, so one stable sort keyed by column gives it: the
nonzeros form one row of ``pow2(nnz)`` slots (``INT32_MAX`` keys pad it)
through kernel K2 (``bitonic.row_sort``), with each nonzero's row id and
float32 value riding as payloads (a float64 value moves by its sorted
slot, ``bitonic.slot_payload``). Row ids are a run-length decode of
``indptr`` by binary search; Aᵀ's row offsets are a cumulative sum of the
column counts (an int32 ``index_add_``).

The sort is one (1, pow2(nnz)) K2 launch: at 2^22 slots and more K2 runs
slower than ``torch.sort`` and a gather (PERF.md), which a large
transpose pays; it is a setup-time operation, as in the reference.
"""

from __future__ import annotations

import torch

from .bitonic import by_slot, slot_payload
from .device_csr import DeviceCSR
from .dia import row_ids
from .esc import _sort_rows

I32 = torch.int32


def _transpose_impl(indptr, indices, data, m: int, n: int):
    nnz = indices.shape[0]
    dev = indices.device
    vals = data.reshape(1, nnz)
    _, (rows_s, moved) = _sort_rows(
        indices.to(I32).reshape(1, nnz),
        [row_ids(indptr, nnz).reshape(1, nnz), slot_payload(vals)])
    data_s = by_slot(vals, moved)
    counts = torch.zeros(n, dtype=I32, device=dev).index_add_(
        0, indices, torch.ones(nnz, dtype=I32, device=dev))
    t_indptr = torch.cat([torch.zeros(1, dtype=I32, device=dev),
                          torch.cumsum(counts, 0, dtype=I32)])
    return t_indptr, rows_s[0], data_s[0]


def transpose(A: DeviceCSR) -> DeviceCSR:
    """Aᵀ as a device CSR on A's device. Canonical input yields canonical
    output; within a column, A's nonzeros keep their flat order."""
    m, n = A.shape
    if m == 0 or A.nnz == 0:
        dev = A.device
        return DeviceCSR(
            indptr=torch.zeros(n + 1, dtype=I32, device=dev),
            indices=torch.zeros(0, dtype=I32, device=dev),
            data=torch.zeros(0, dtype=A.data.dtype, device=dev),
            shape=(n, m), nnz=0, canonical=True)
    t_indptr, t_indices, t_data = _transpose_impl(
        A.indptr, A.indices[:A.nnz], A.data[:A.nnz], m, n)
    return DeviceCSR(indptr=t_indptr, indices=t_indices, data=t_data,
                     shape=(n, m), nnz=A.nnz, canonical=A.canonical)
