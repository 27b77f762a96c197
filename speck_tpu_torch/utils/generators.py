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


def make_mixed(n=65536, half_band=16, n_out=1024, out_nnz=64,
               seed=13) -> HostCSR:
    """Banded matrix plus a clustered block of outlier rows (the first
    n_out) holding out_nnz random columns each (bench config 1b:
    ``make_mixed()``): the outliers break the whole-matrix DIA gate, so
    the per-row DIA split takes the banded bulk and the stream the rest.
    float64 values."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    offs = list(range(-half_band, half_band + 1))
    band = sp.diags(
        [rs.standard_normal(n - abs(o)) for o in offs], offs,
        shape=(n, n), format="csr")
    out_rows = np.repeat(np.arange(n_out), out_nnz)
    extra = sp.csr_matrix(
        (rs.standard_normal(out_rows.shape[0]),
         (out_rows, rs.randint(0, n, out_rows.shape[0]))), shape=(n, n))
    mat = (band + extra).tocsr()
    mat.sum_duplicates()
    return HostCSR.from_scipy(mat)


def make_stencil27(g=102, seed=19) -> HostCSR:
    """3-D 27-point stencil on a g^3 grid (the bench's ``stencil27``:
    ``make_stencil27(102)``, 1,061,208 rows): 27 present diagonals spread
    over a band about 2 g^2 wide, the sparse-DIA class. float64 values."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    n = g ** 3
    offs = sorted(dz * g * g + dy * g + dx
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1))
    mat = sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                   shape=(n, n), format="csr")
    return HostCSR.from_scipy(mat)


def make_giant_row(mg=40000, NH=5000, HN=10000, seed=17) -> HostCSR:
    """The bench's giant-row matrix (``bench.py`` ``giant_row_5e7_products
    _AxA``), whose defaults it gives exactly; the bench's offsets 10000,
    25000 and 5000 are mg/4, 5mg/8 and mg/8 here, so a smaller mg scales
    the same shape. Row 0 holds NH entries, at the columns of the heavy rows
    mg/4..; each heavy row holds HN entries at shifted columns from 5mg/8
    on (HN <= mg/4), so row 0 of A @ A has NH * HN products (5 * 10^7);
    rows 1 .. mg/8 - 1 hold 16 random entries each. float64 values."""
    import scipy.sparse as sp

    q, cb, nl = mg // 4, 5 * mg // 8, mg // 8
    rsg = np.random.RandomState(seed)
    hrow = np.repeat(np.arange(q, q + NH), HN)
    hcol = ((np.tile(np.arange(HN), NH)
             + np.repeat(np.arange(NH) * 37, HN)) % q) + cb
    lr = np.repeat(np.arange(1, nl), 16)
    lc = rsg.randint(1, nl, lr.shape[0])
    gm = sp.csr_matrix(
        (rsg.standard_normal(NH + hrow.shape[0] + lr.shape[0]),
         (np.concatenate([np.zeros(NH, int), hrow, lr]),
          np.concatenate([np.arange(q, q + NH), hcol, lc]))),
        shape=(mg, mg))
    gm.sum_duplicates()
    return HostCSR.from_scipy(gm)


def make_prolongation(m=65536, mc=16384, seed=11) -> HostCSR:
    """An AMG-style prolongation: m rows of one unit entry each at a random
    one of mc columns (bench config 4's P: ``make_prolongation(65536,
    16384)``), float64 values."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    return HostCSR.from_scipy(sp.csr_matrix(
        (np.ones(m), (np.arange(m), rs.randint(0, mc, m))), shape=(m, mc)))
