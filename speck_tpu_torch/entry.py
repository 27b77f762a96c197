"""The port's counterpart of the repository's ``__graft_entry__.entry()``:
the fused expand-sort-contract SpGEMM (``ops.esc.esc_fixed``) with seeded
example arguments.

    fn, args = entry()            # tensors on the first CUDA card
    counts, cols, vals = fn(*args)
"""

from __future__ import annotations

import numpy as np
import torch

from .formats.csr import HostCSR
from .utils.device import resolve_device


def _example_matrices(m=64, k=64, n=64, density=0.1, seed=7):
    """The same seeded scipy matrices as ``__graft_entry__``."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    a = sp.random(m, k, density, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz)
    b = sp.random(k, n, density, format="csr", random_state=rs)
    b.data = rs.standard_normal(b.nnz)
    return HostCSR.from_scipy(a), HostCSR.from_scipy(b)


def fixed_cap(a: HostCSR, b: HostCSR) -> int:
    """The fixed-cap rule of the JAX mesh path: the next power of two of
    the largest per-row max(products, A length), at least 1."""
    a_len = np.diff(np.asarray(a.row_offsets, np.int64))
    b_len = np.diff(np.asarray(b.row_offsets, np.int64))
    ops = np.zeros(a.rows, np.int64)
    np.add.at(ops, np.repeat(np.arange(a.rows), a_len),
              b_len[np.asarray(a.col_ids, np.int64)])
    work = int(max(np.maximum(ops, a_len).max(initial=0), 1))
    return 1 << (work - 1).bit_length() if work > 1 else 1


def esc_args(a: HostCSR, b: HostCSR, device, dtype=np.float32):
    """``esc_fixed``'s seven arguments for A and B on ``device``: A's CSR,
    then B as per-row (start, length) and its columns and values, the
    values in ``dtype`` (float32 or float64)."""
    device = resolve_device(device)

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=dt),
                               device=device)

    bp = np.asarray(b.row_offsets, np.int32)
    return (put(a.row_offsets, np.int32), put(a.col_ids, np.int32),
            put(a.data, dtype), put(bp[:-1], np.int32),
            put(bp[1:] - bp[:-1], np.int32), put(b.col_ids, np.int32),
            put(b.data, dtype))


def entry(device=None):
    """(fn, example_args): ``esc_fixed`` at cap 256 on the example matrices,
    the arguments on ``device`` (the first CUDA card unless ``"cpu"``)."""
    from .ops.esc import esc_fixed

    a, b = _example_matrices()
    cap, n_cols = 256, b.cols

    def fn(a_indptr, a_indices, a_data, b_start, b_len, b_indices, b_data):
        return esc_fixed(a_indptr, a_indices, a_data, b_start, b_len,
                         b_indices, b_data, cap=cap, n_cols=n_cols)

    return fn, esc_args(a, b, device)
