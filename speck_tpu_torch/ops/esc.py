"""Direct-copy rows and the packed B record.

``direct_chunk`` fills single-A-nonzero rows: C row = valA * B row, already
sorted, a gather plus a masked scatter with no expansion or sort.
``pack_csr_arrays`` interleaves (col id, value bits) into one (nnz, 2)
int32 record, so each product's B read is one 8-byte gather.
"""

from __future__ import annotations

import torch


def pack_csr_arrays(indices: torch.Tensor, data: torch.Tensor
                    ) -> torch.Tensor:
    """(nnz, 2) int32 record of (col id, float32 value bits)."""
    return torch.stack([indices.to(torch.int32),
                        data.contiguous().view(torch.int32)], dim=-1)


def packable(data) -> bool:
    return data.dtype.itemsize == 4


def direct_chunk(rows_padded, start: int, valid: int, a_indptr, a_indices,
                 a_data, b_indptr, b_indices, b_data, row_offsets, c_cols,
                 c_vals, *, chunk_rows: int, cap: int):
    """Numeric fill of sorted rows [start, start + valid) of
    ``rows_padded``, each a single A nonzero times one (canonical) B row
    of at most ``cap`` entries, into C's padded output buffers in place
    (their last slot takes the dropped writes)."""
    dev = rows_padded.device
    rows = rows_padded[start: start + chunk_rows]
    valid_rows = torch.arange(chunk_rows, dtype=torch.int32,
                              device=dev) < valid
    r = torch.where(valid_rows, rows, 0)
    p = a_indptr[r]
    acol = a_indices[p]
    aval = a_data[p]
    b0 = b_indptr[acol]
    blen = b_indptr[acol + 1] - b0
    t = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    valid_t = (t < blen[:, None]) & valid_rows[:, None]
    src = torch.where(valid_t, b0[:, None] + t, 0)
    oob = c_cols.shape[0] - 1
    flat = torch.where(valid_t, row_offsets[r][:, None] + t, oob)
    c_cols.index_put_((flat,), b_indices[src])
    c_vals.index_put_((flat,), aval[:, None] * b_data[src])
    return c_cols, c_vals
