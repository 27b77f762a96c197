"""The trilinear prolongation P of a geometric multigrid's coarsening of
HPCG's grid, as an operand that a traffic mix names.

HPCG's coarsening (``GenerateCoarseProblem.cpp``, ``f2cOperator``) keeps
every ``f``-th point of each axis (``f`` = 2): fine point ``f c`` is
coarse point ``c``, so an axis of ``n`` points has ``(n - 1) // f + 1``
coarse points. P interpolates linearly along each axis, as PETSc's
``DMCreateInterpolation`` does for a DMDA (Q1) under ``PCMG
-pc_mg_galerkin``: fine point ``f c + r`` takes coarse point ``c`` with
weight ``1 - r / f`` and ``c + 1`` with ``r / f``; a coarse point past the
end of the axis is dropped, as ``GenerateProblem_ref.cpp`` drops the
neighbours outside the grid (at ``f`` = 2 and an even ``n`` the last fine
point takes its one coarse point at 1/2). The 3-D weight is the product of
the three axes' weights, and the points run with ``x`` fastest, as the
operator's rows do. Closed forms at ``f`` = 2 for an even side ``n``: the
shape ``n^3 x (n/2)^3`` and nnz ``(3n/2 + 1)^3``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from speckbench.inputs import Structure


def axis(n: int, f: int):
    """One axis: (coarse points, (n, 2) coarse columns, (n, 2) weights);
    a weight of 0 marks no entry, and columns ascend along each row."""
    nc = (n - 1) // f + 1
    c, r = np.divmod(np.arange(n), f)
    cols = np.stack([c, c + 1], 1)
    w = np.stack([1.0 - r / f, r / f], 1)
    w[cols >= nc] = 0.0
    return nc, np.minimum(cols, nc - 1), w


def operand(cfg: dict, params: dict) -> Tuple[Structure, np.ndarray]:
    """P on the configuration's grid (``nx``, ``ny``, ``nz``) at the
    traffic's ``coarsen`` factor: its structure and its float64 weights,
    the same for every seed."""
    f = int(params["coarsen"])
    (ncz, cz, wz), (ncy, cy, wy), (ncx, cx, wx) = (
        axis(int(cfg[k]), f) for k in ("nz", "ny", "nx"))
    n = cz.shape[0] * cy.shape[0] * cx.shape[0]
    # (z, y, x, kz, ky, kx): the 8 candidates of each row, in ascending
    # column order since each axis's two columns ascend
    col = ((cz[:, None, None, :, None, None] * ncy
            + cy[None, :, None, None, :, None]) * ncx
           + cx[None, None, :, None, None, :]).reshape(n, 8)
    w = (wz[:, None, None, :, None, None] * wy[None, :, None, None, :, None]
         * wx[None, None, :, None, None, :]).reshape(n, 8)
    keep = w > 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(keep.sum(1), out=indptr[1:])
    st = Structure(rows=n, cols=ncz * ncy * ncx, indptr=indptr,
                   indices=col[keep].astype(np.int32))
    return st, w[keep]
