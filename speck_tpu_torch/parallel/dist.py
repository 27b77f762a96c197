"""Host conversion of the fixed-cap (counts, cols, vals) layout.

A numpy copy of ``padded_to_host_csr`` from ``speck_tpu/parallel/dist.py``
(that module imports jax). The fixed-cap mesh path itself is not ported.
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import HostCSR


def _numpy(x):
    """A numpy array from a torch tensor (on any device) or an array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def padded_to_host_csr(counts, cols, vals, m: int, n: int) -> HostCSR:
    """Convert the padded row-major output of ``esc_fixed`` (identity row
    layout, pad rows at the tail) to a HostCSR."""
    counts = _numpy(counts)[:m]
    cols = _numpy(cols)[:m]
    vals = _numpy(vals)[:m]
    offsets = np.zeros(m + 1, np.int64)
    np.cumsum(counts.astype(np.int64), out=offsets[1:])
    width = cols.shape[1] if cols.ndim == 2 else 0
    mask = np.arange(width)[None, :] < counts[:, None]
    return HostCSR(
        rows=m,
        cols=n,
        row_offsets=offsets,
        col_ids=cols[mask],
        data=vals[mask],
    )
