"""The port's device transpose against speck_tpu on the CPU, and the
Galerkin product Pᵀ·(A·P) of bench config 4 at a sixteenth of its size.

The same seeded inputs, made with numpy, go through ``transpose`` of both
packages and scipy's ``.T.tocsr()``. Tolerances: the transpose moves
values without arithmetic, so Aᵀ's row offsets, column ids and values are
exactly equal to JAX's and to scipy's; C = A·P and Pᵀ·(A·P) have
structure exactly equal to JAX's and to the scipy oracle's, values within
rtol 2e-3 (float32, the reference's own tolerance) or 1e-12 of JAX's
(float64, JAX under ``jax_enable_x64``, restored after the test) and
1e-9 of the oracle."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu.ops.transpose import transpose as jtranspose
from speck_tpu_torch.ops.device_csr import torch_dtype
from speck_tpu_torch.utils import generators as gen

JAX_TOL = {np.float32: 2e-3, np.float64: 1e-12}
ORACLE_TOL = {np.float32: 2e-3, np.float64: 1e-9}


@pytest.fixture()
def x64():
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _both(mat, dtype):
    h = st.HostCSR.from_scipy(mat) if sp.issparse(mat) else mat
    Tj = st.device_get_csr(jtranspose(st.device_put_csr(h, dtype)))
    At = pt.device_put_csr(pt.HostCSR.from_host(h), dtype, device="cpu")
    Tt = pt.transpose(At)
    return h, Tj, Tt, At


def _against_scipy(h, T):
    ref = sp.csr_matrix((np.asarray(h.data), np.asarray(h.col_ids),
                         np.asarray(h.row_offsets)),
                        shape=(h.rows, h.cols)).T.tocsr()
    ref.sort_indices()
    Th = pt.device_get_csr(T)
    assert (Th.rows, Th.cols) == ref.shape
    _eq(np.asarray(Th.row_offsets, np.int64), ref.indptr, "row offsets")
    _eq(np.asarray(Th.col_ids, np.int64), ref.indices, "column ids")
    _eq(Th.data, ref.data.astype(Th.data.dtype), "values")
    return Th


def _equal_to_jax(Tj, Th):
    _eq(np.asarray(Th.row_offsets, np.int64),
        np.asarray(Tj.row_offsets, np.int64))
    _eq(np.asarray(Th.col_ids, np.int64), np.asarray(Tj.col_ids, np.int64))
    _eq(Th.data, Tj.data)


def test_device_transpose_as_the_reference_tests_it():
    """tests/test_formats.py's random 37 x 53 input in float32: equal to
    JAX's and to scipy's, and canonical."""
    rs = np.random.RandomState(263)
    a = sp.random(37, 53, 0.15, format="csr", random_state=rs)
    a.data = (rs.standard_normal(a.nnz) + 0.5)
    h, Tj, Tt, _ = _both(a, np.float32)
    assert Tt.canonical and Tt.shape == (53, 37) and Tt.nnz == a.nnz
    _equal_to_jax(Tj, _against_scipy(h, Tt))


@pytest.mark.parametrize("shape", [(300, 40), (40, 300), (1, 500),
                                   (500, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_rectangular_transpose(shape, dtype, request):
    if dtype == np.float64:
        request.getfixturevalue("x64")
    rs = np.random.RandomState(shape[0] * 7 + shape[1])
    a = sp.random(*shape, 0.2, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz)
    h, Tj, Tt, _ = _both(a, dtype)
    assert Tt.data.dtype == torch_dtype(dtype)
    _equal_to_jax(Tj, _against_scipy(h, Tt))


@pytest.mark.parametrize("shape", [(4, 6), (0, 5), (5, 0)])
def test_empty_transpose(shape):
    """No nonzeros (or no rows): an empty (n, m) canonical CSR, as the
    reference's early return."""
    m, n = shape
    h = st.HostCSR(rows=m, cols=n, row_offsets=np.zeros(m + 1, np.int64),
                   col_ids=np.zeros(0, np.int64), data=np.zeros(0))
    _, Tj, Tt, _ = _both(h, np.float32)
    assert Tt.shape == (n, m) and Tt.nnz == 0 and Tt.canonical
    _eq(Tt.indptr.numpy(), np.zeros(n + 1, np.int32))
    _eq(np.asarray(Tj.row_offsets, np.int64), np.zeros(n + 1, np.int64))


def test_non_canonical_transpose():
    """Columns unsorted within rows (a non-canonical input): Aᵀ is in
    (column, row) order all the same, equal to JAX's and scipy's, and keeps
    the input's canonical flag, as the reference does."""
    rs = np.random.RandomState(5)
    a = sp.random(60, 45, 0.2, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz)
    ip, ix, d = a.indptr.copy(), a.indices.copy(), a.data.copy()
    for r in range(60):
        s, e = ip[r], ip[r + 1]
        p = rs.permutation(e - s)
        ix[s:e], d[s:e] = ix[s:e][p], d[s:e][p]
    h = st.HostCSR(rows=60, cols=45, row_offsets=ip, col_ids=ix, data=d)
    h2, Tj, Tt, At = _both(h, np.float32)
    assert not At.canonical and not Tt.canonical
    _equal_to_jax(Tj, _against_scipy(h2, Tt))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_galerkin_product_matches_jax_and_scipy(dtype, request):
    """Bench config 4 at a sixteenth of its size: A = make_banded(4096, 16,
    seed=3), P = make_prolongation(4096, 1024). A·P streams in both
    packages; Pᵀ by the device transpose equals scipy's P.T; Pᵀ·(A·P)
    equals JAX's and scipy's."""
    if dtype == np.float64:
        request.getfixturevalue("x64")
    a, p = gen.make_banded(4096, 16, 3), gen.make_prolongation(4096, 1024)
    aj, pj_h = (st.HostCSR(x.rows, x.cols, x.row_offsets, x.col_ids, x.data)
                for x in (a, p))
    Aj, Pj = st.device_put_csr(aj, dtype), st.device_put_csr(pj_h, dtype)
    At, Pt = (pt.device_put_csr(x, dtype, device="cpu") for x in (a, p))
    plan_j = st.plan_spgemm(Aj, Pj)
    plan_t = pt.plan_spgemm(At, Pt)
    assert plan_t.dia is None and plan_t.dense is None
    assert plan_j.dia is None and plan_j.dense is None
    assert plan_t.stream.layout.n_stream_rows == a.rows
    assert plan_t.nnz == plan_j.nnz
    APj, APt = plan_j.execute(), plan_t.execute()
    PTj, PTt = jtranspose(Pj), pt.transpose(Pt)
    pts = _against_scipy(p, PTt)
    _equal_to_jax(st.device_get_csr(PTj), pts)
    Gj = st.device_get_csr(st.spgemm(PTj, APj))
    Gt = pt.device_get_csr(pt.spgemm(PTt, APt))
    tol = JAX_TOL[dtype]
    for got, want in ((pt.device_get_csr(APt), st.device_get_csr(APj)),
                      (Gt, Gj)):
        _eq(np.asarray(got.row_offsets, np.int64),
            np.asarray(want.row_offsets, np.int64))
        _eq(np.asarray(got.col_ids, np.int64),
            np.asarray(want.col_ids, np.int64))
        np.testing.assert_allclose(got.data, want.data, rtol=tol,
                                   atol=tol * 1e-1)
    As, Ps = a.to_scipy(), p.to_scipy()
    g = (Ps.T.tocsr() @ (As @ Ps)).tocsr()
    g.sort_indices()
    ref = pt.HostCSR.from_scipy(g)
    r = pt.compare_csr(ref, Gt, compare_data=True, rel_tol=ORACLE_TOL[dtype])
    assert r.ok, r.message
    assert Gt.rows == Gt.cols == 1024
