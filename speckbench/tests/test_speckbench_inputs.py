"""The generators' sizes and determinism, and the value sets."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from speckbench.generators import kronecker, stencil27
from speckbench.inputs import Structure, draw_values

GRAPH = {"SCALE": 15, "edgefactor": 16, "initiator": [0.57, 0.19, 0.19, 0.05],
         "graph_seed": 1}


def products(st: Structure) -> int:
    return int(np.diff(st.indptr)[st.indices].astype(np.int64).sum())


def scipy_of(st: Structure):
    return sp.csr_matrix((np.ones(st.nnz), st.indices, st.indptr),
                         shape=(st.rows, st.cols))


@pytest.mark.parametrize("n", [16, 32])
def test_stencil27_closed_forms(n):
    st = stencil27.structure({"nx": n, "ny": n, "nz": n}, 0)
    a = scipy_of(st)
    assert st.nnz == (3 * n - 2) ** 3
    assert products(st) == (9 * n - 10) ** 3
    assert (a @ a).nnz == (5 * n - 6) ** 3
    assert a.has_sorted_indices and (a != a.T).nnz == 0


def test_stencil27_rows_are_hpcg_neighbourhoods():
    nx, ny, nz = 5, 4, 3
    st = stencil27.structure({"nx": nx, "ny": ny, "nz": nz}, 0)
    for r in range(st.rows):
        iz, iy, ix = r // (nx * ny), r // nx % ny, r % nx
        want = [(iz + sz) * nx * ny + (iy + sy) * nx + ix + sx
                for sz in (-1, 0, 1) for sy in (-1, 0, 1) for sx in (-1, 0, 1)
                if 0 <= iz + sz < nz and 0 <= iy + sy < ny
                and 0 <= ix + sx < nx]
        got = st.indices[st.indptr[r]:st.indptr[r + 1]].tolist()
        assert got == want


def test_kronecker_graph_comes_from_its_graph_seed():
    cfg = dict(GRAPH, SCALE=10)
    a, b = kronecker.structure(cfg, 7), kronecker.structure(cfg, 2 ** 33 + 8)
    for f in ("indptr", "indices", "value_index"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    d = kronecker.structure(dict(cfg, graph_seed=2), 7)
    assert (d.nnz, products(d)) != (a.nnz, products(a))


def test_kronecker_graph_is_simple_and_undirected():
    st = kronecker.structure(dict(GRAPH, SCALE=10), 2 ** 31 + 11)
    a = scipy_of(st)
    assert a.has_sorted_indices and a.diagonal().sum() == 0
    assert (a != a.T).nnz == 0 and a.max() == 1
    # both entries of an edge draw one weight
    w = sp.csr_matrix((st.value_index.astype(float) + 1, st.indices,
                       st.indptr), shape=a.shape)
    assert (w != w.T).nnz == 0
    assert st.n_values == st.nnz // 2


@pytest.mark.parametrize("scale,graph_seed,nnz,prods", [
    (15, 1, 882370, 441822050), (15, 2, 883618, 443112228),
    (15, 3, 882446, 443404040), (14, 1, 426548, 156764404)])
def test_kronecker_sizes(scale, graph_seed, nnz, prods):
    cfg = dict(GRAPH, SCALE=scale, graph_seed=graph_seed)
    for seed in (1, 2 ** 31 + 99):
        st = kronecker.structure(cfg, seed)
        assert (st.rows, st.nnz, products(st)) == (1 << scale, nnz, prods)


def test_value_sets_differ_and_repeat():
    st = kronecker.structure(dict(GRAPH, SCALE=8), 3)
    cfg = {"values": "uniform", "value_dtype": "float32"}
    v0 = draw_values(st, cfg, 5, 0, "cpu")
    assert v0.dtype == torch.float32 and v0.shape == (st.nnz,)
    assert torch.equal(v0, draw_values(st, cfg, 5, 0, "cpu"))
    assert not torch.equal(v0, draw_values(st, cfg, 5, 1, "cpu"))
    assert float(v0.min()) >= 0.0 and float(v0.max()) < 1.0
    w = sp.csr_matrix((v0.numpy(), st.indices, st.indptr),
                      shape=(st.rows, st.cols))
    assert (w != w.T).nnz == 0
    hs = stencil27.structure({"nx": 4, "ny": 4, "nz": 4}, 0)
    v = draw_values(hs, {"values": "normal", "value_dtype": "float64"},
                    2 ** 40 + 3, 2, "cpu")
    assert v.dtype == torch.float64 and v.shape == (hs.nnz,)
