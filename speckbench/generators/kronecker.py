"""Graph500's Kronecker graph: the specification's generator, vectorised.

``kronecker_generator(SCALE, edgefactor)`` of the Graph500 specification
draws ``edgefactor * 2^SCALE`` edges, each bit of both endpoints from the
initiator ``[A B; C D]``, then relabels the vertices by a random
permutation. Both come from the configuration's ``graph_seed``, as the
specification's reference code draws its graph from a fixed seed: every
run multiplies the same graph, and the run's seed draws its weights. The graph is undirected, and self-loops and repeated edges
are dropped, as the specification's kernel 1 builds it: A holds ``(i, j)``
and ``(j, i)`` for each distinct edge. Each undirected edge draws one
weight (the SSSP kernel's uniform ``[0, 1)``), so A is symmetric in value
too: ``Structure.value_index`` maps both entries to one draw. The
specification also permutes the edge list; with weights drawn per distinct
edge after the sort, that permutation changes nothing here and is left out.
"""

from __future__ import annotations

import numpy as np

from speckbench.inputs import Structure


def structure(cfg: dict, seed: int) -> Structure:
    """The graph's structure, drawn from ``cfg["graph_seed"]`` (the run's
    seed draws only the weights, ``speckbench.inputs``)."""
    scale = int(cfg["SCALE"])
    a, b, c, _ = (float(x) for x in cfg["initiator"])
    n = 1 << scale
    m = int(cfg["edgefactor"]) * n
    rng = np.random.default_rng(int(cfg["graph_seed"]))
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ii = np.zeros(m, np.int64)
    jj = np.zeros(m, np.int64)
    for bit in range(scale):
        ii_bit = rng.random(m) > ab
        jj_bit = rng.random(m) > np.where(ii_bit, c_norm, a_norm)
        ii |= ii_bit.astype(np.int64) << bit
        jj |= jj_bit.astype(np.int64) << bit
    perm = rng.permutation(n)
    ii, jj = perm[ii], perm[jj]
    keep = ii != jj
    lo = np.minimum(ii, jj)[keep]
    hi = np.maximum(ii, jj)[keep]
    pairs = np.unique(lo * n + hi)
    lo, hi = pairs // n, pairs % n
    rows = np.concatenate([lo, hi])
    cols = np.concatenate([hi, lo])
    pid = np.tile(np.arange(pairs.shape[0], dtype=np.int64), 2)
    order = np.argsort(rows * n + cols, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return Structure(rows=n, cols=n, indptr=indptr,
                     indices=cols[order].astype(np.int32),
                     value_index=pid[order], n_values=pairs.shape[0])
