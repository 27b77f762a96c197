"""HPCG's 27-point operator: the structure of ``GenerateProblem_ref.cpp``.

Row ``(iz, iy, ix)`` of an ``nx * ny * nz`` grid (``ix`` fastest) holds
one entry for each of the 27 neighbours ``(iz + sz, iy + sy, ix + sx)``,
``sz, sy, sx`` in ``-1, 0, 1``, that lies inside the grid; neighbours
outside are dropped, so boundary rows are shorter. HPCG's loop order gives
ascending columns within a row, as here. HPCG writes 26 on the diagonal
and -1 elsewhere; the values here come from the configuration's
distribution (``speckbench.inputs``). Closed forms for a cube of side
``n``: nnz ``(3n - 2)^3``, products of A @ A ``(9n - 10)^3`` and nnz(A @ A)
``(5n - 6)^3``.
"""

from __future__ import annotations

import numpy as np

from speckbench.inputs import Structure


def structure(cfg: dict, seed: int) -> Structure:
    """The operator's structure (the same for every seed)."""
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    n = nx * ny * nz
    step = np.array([-1, 0, 1])
    # (axis length, 3) masks: neighbour sx of coordinate x lies inside
    inside = [((np.arange(k)[:, None] + step) >= 0)
              & ((np.arange(k)[:, None] + step) < k) for k in (nz, ny, nx)]
    mask = (inside[0][:, None, None, :, None, None]
            & inside[1][None, :, None, None, :, None]
            & inside[2][None, None, :, None, None, :]).reshape(n, 27)
    offs = (step[:, None, None] * (nx * ny) + step[None, :, None] * nx
            + step[None, None, :]).reshape(27)
    cols = np.arange(n, dtype=np.int32)[:, None] + offs.astype(np.int32)
    indices = cols[mask]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(mask.sum(1), out=indptr[1:])
    return Structure(rows=n, cols=n, indptr=indptr, indices=indices)
