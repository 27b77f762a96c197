"""Gather emission of row-staged output planes (torch port of
``speck_tpu/ops/dense.py``'s ``dense_gather_emit``; the dense-tile route
itself is not ported yet).

The DIA route emits with it when its uniform fast path is not taken.
"""

from __future__ import annotations

import torch

from .stream import _count_le

I32 = torch.int32


def dense_gather_emit(cols_c, vals_c, row_offsets, *, tile_rows: int,
                      cw: int, m: int, nnz: int = 0):
    """The final CSR arrays by gather from staged planes that cover rows
    0..m in order, so output row r's staged slots live at flat index
    r * cw + o. One read per output: the per-row term r * cw -
    row_offsets[r] is constant over a row's output segment; the reference
    seeds it at each live row's start and forward-fills it, here each
    output looks its row up by a binary search over the row ends.
    ``tile_rows`` and ``m`` are the reference's static arguments (the
    layout rule above holds for any tile height)."""
    total = nnz if nnz else 1
    i = torch.arange(total, dtype=I32, device=cols_c.device)
    n_rows = row_offsets.shape[0] - 1
    r = torch.clamp(_count_le(row_offsets[1:], i), 0, n_rows - 1)
    src = torch.clamp(r * cw - row_offsets[r] + i, 0, cols_c.numel() - 1)
    return cols_c.reshape(-1)[src], vals_c.reshape(-1)[src]
