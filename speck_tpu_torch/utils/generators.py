"""Seeded input generators, copied from the repository's ``bench.py`` (which
imports ``speck_tpu``) so the port can make the same matrices on its own."""

from __future__ import annotations

import numpy as np

from ..formats.csr import HostCSR


def make_powerlaw(m=131072, avg=12, alpha=2.2, seed=5) -> HostCSR:
    """Square matrix with Pareto-distributed row lengths (bench configs 2
    and 3: ``make_powerlaw(131072, seed=5)`` and
    ``make_powerlaw(262144, seed=7)``), float64 values."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    lens = np.minimum((rs.pareto(alpha, m) + 1) * avg * 0.5, m // 4
                      ).astype(np.int64)
    rows = np.repeat(np.arange(m), lens)
    cols = rs.randint(0, m, rows.shape[0])
    vals = rs.standard_normal(rows.shape[0])
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    return HostCSR.from_scipy(mat)


def make_banded(n=65536, half_band=16, seed=3) -> HostCSR:
    """Square banded matrix with 2 * half_band + 1 diagonals of standard
    normal values (bench config 1: ``make_banded(65536, 16, seed=3)``),
    float64 values."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    offs = list(range(-half_band, half_band + 1))
    mat = sp.diags(
        [rs.standard_normal(n - abs(o)) for o in offs], offs,
        shape=(n, n), format="csr",
    )
    return HostCSR.from_scipy(mat)
