"""The port's dense-tile route against speck_tpu on the CPU.

Every case of tests/test_dense.py, with its configuration (16-row tiles,
64-wide windows, DIA off), runs in float32 and float64 and under both
``dense_densify`` values through both packages on the same seeded input,
made with numpy. Held equal: the DenseGroup fields (r0s, kbases, cbases,
valids, boffs, kw, cw, la, lb, full_cover), the staged counts and columns
of every dense batch, the row offsets and column ids of C.
Tolerances: values within rtol 2e-3 of JAX's and of the scipy oracle in
float32 (the reference's own tolerance: the window products sum in
another order); in float64 within 1e-12 of JAX's (JAX under
``jax_enable_x64``, restored after the test) and 1e-9 of the oracle.
Then the calls that raised before the route was ported: a row-blocked
call and a DeviceCSR without a host copy, and replay with new values."""

import importlib

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu_torch.ops import dense as tdense

tsp = importlib.import_module("speck_tpu_torch.ops.spgemm")

_DENSE_KW = dict(product_budget=1 << 14, dense_tile_rows=16, dense_kw=64,
                 dense_cw=64, dense_la=16, dense_lb=16, enable_dia=False)
JAX_TOL = {np.float32: 2e-3, np.float64: 1e-12}
ORACLE_TOL = {np.float32: 2e-3, np.float64: 1e-9}
DTYPES = [np.float32, np.float64]
DENSIFY = ["sort", "scatter"]


@pytest.fixture()
def x64(request):
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _banded(n, hb, rs):
    offs = list(range(-hb, hb + 1))
    return sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                    shape=(n, n), format="csr").tocsr()


def _with_outliers(n, hb, out_rows, rs):
    a = _banded(n, hb, rs).tolil()
    for r in out_rows:
        cols = rs.randint(0, n, 16)
        a[r, cols] = rs.standard_normal(len(cols))
    return a.tocsr()


# the cases of tests/test_dense.py: (A, B or None, extra config keywords),
# each input made from its own seed
def _case(name):
    rs = np.random.RandomState(sum(map(ord, name)))
    if name == "banded_routes_dense":
        return _banded(96, 3, rs), None, {}
    if name == "mixed_with_stream":
        a = _banded(64, 2, rs).tolil()
        a[5, :] = rs.standard_normal(64)
        a[33, ::2] = rs.standard_normal(32)
        return a.tocsr(), None, {}
    if name == "exact_zero_structure":
        a = sp.csr_matrix((np.array([1.0, -1.0, 1.0, 1.0]),
                           (np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1]))),
                          shape=(32, 32))
        b = sp.csr_matrix((np.array([1.0, 1.0]),
                           (np.array([0, 1]), np.array([0, 0]))),
                          shape=(32, 32))
        return a, b, {}
    if name == "rectangular":
        a = sp.random(48, 64, 0.1, format="csr",
                      random_state=np.random.RandomState(7))
        a.data = rs.standard_normal(a.nnz)
        b = sp.random(64, 40, 0.15, format="csr",
                      random_state=np.random.RandomState(8))
        b.data = rs.standard_normal(b.nnz)
        return a, b, {}
    if name == "reexecute_new_values":
        return _banded(64, 2, rs), None, {}
    if name == "disabled_matches":
        return _banded(80, 2, rs), None, {}
    if name == "pure_gather_emit":
        a = _banded(96, 3, rs).tolil()
        a[17, :] = 0
        a[95, :] = 0
        a = a.tocsr()
        a.eliminate_zeros()
        return a, None, {}
    if name == "ineligible_groupless_tile":
        a = _banded(96, 3, rs).tolil()
        b = _banded(96, 3, rs).tolil()
        b[40:60, :] = 0
        for r in range(32, 48):
            a[r, :] = 0
            for c in range(40, 60):
                a[r, c] = 1.0
        a, b = a.tocsr(), b.tocsr()
        a.eliminate_zeros()
        b.eliminate_zeros()
        return a, b, {}
    if name == "gather_emit_multibatch":
        return _banded(96, 3, rs), None, dict(dense_tiles_per_dispatch=2)
    if name == "outliers_clustered":
        return (_with_outliers(1024, 3, range(0, 32), rs), None,
                dict(dense_tile_rows=64, dense_kw=128, dense_cw=128))
    raise KeyError(name)


CASES = ["banded_routes_dense", "mixed_with_stream", "exact_zero_structure",
         "rectangular", "reexecute_new_values", "disabled_matches",
         "pure_gather_emit", "ineligible_groupless_tile",
         "gather_emit_multibatch", "outliers_clustered"]


def _put(h, dtype):
    return (st.device_put_csr(h, dtype),
            pt.device_put_csr(pt.HostCSR.from_host(h), dtype, device="cpu"))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _close(got, want, dtype, what=""):
    tol = JAX_TOL[dtype]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol * 1e-1, err_msg=what)


def _dense_fields_equal(dj, dt):
    for f in ("r0s", "kbases", "cbases", "valids"):
        _eq(getattr(dt, f), getattr(dj, f), f)
    for f in ("boffs", "tile_rows", "kw", "cw", "la", "lb", "full_cover"):
        assert getattr(dt, f) == getattr(dj, f), f


def _staged_equal(pj, ptp, dtype):
    assert len(ptp.dense_staged) == len(pj.dense_staged)
    for sj, stt in zip(pj.dense_staged, ptp.dense_staged):
        _eq(stt[0], sj[0], "staged counts")
        _eq(stt[1], sj[1], "staged columns")
        _close(stt[2], sj[2], dtype, "staged values")


def _assert_c(ah, bh, Cj, Ct, dtype):
    """Structure equal to JAX's, values within JAX_TOL of JAX's and within
    ORACLE_TOL of the scipy oracle."""
    _eq(np.asarray(Ct.row_offsets, np.int64),
        np.asarray(Cj.row_offsets, np.int64), "row offsets")
    _eq(np.asarray(Ct.col_ids, np.int64), np.asarray(Cj.col_ids, np.int64),
        "column ids")
    assert Ct.data.dtype == np.dtype(dtype)
    _close(Ct.data, Cj.data, dtype, "values")
    r = pt.compare_csr(pt.oracle_spgemm(pt.HostCSR.from_host(ah),
                                        pt.HostCSR.from_host(bh)),
                       Ct, compare_data=True, rel_tol=ORACLE_TOL[dtype])
    assert r.ok, r.message


def _run(name, dtype, densify):
    a, b, kw = _case(name)
    kw = dict(_DENSE_KW, dense_densify=densify, **kw)
    ah = st.HostCSR.from_scipy(a)
    bh = ah if b is None else st.HostCSR.from_scipy(b)
    Aj, At = _put(ah, dtype)
    Bj, Bt = (Aj, At) if b is None else _put(bh, dtype)
    pj = st.plan_spgemm(Aj, Bj, st.SpgemmConfig(**kw))
    ptp = pt.plan_spgemm(At, Bt, pt.SpgemmConfig(**kw))
    return ah, bh, (Aj, Bj, pj), (At, Bt, ptp), kw


@pytest.mark.parametrize("densify", DENSIFY)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_dense_case_matches_jax(case, dtype, densify, request, monkeypatch):
    """One case of tests/test_dense.py through both packages: the dense
    group and its staged batches equal, the route's own assertion (pure
    dense, mixed, gather emit or not), C against JAX and the oracle."""
    if dtype == np.float64:
        request.getfixturevalue("x64")
    jsp = importlib.import_module("speck_tpu.ops.spgemm")
    calls = {"jax": 0, "port": 0}
    for mod, who in ((jsp, "jax"), (tsp, "port")):
        real = mod.dense_gather_emit

        def counted(*a, _real=real, _who=who, **k):
            calls[_who] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, "dense_gather_emit", counted)
    ah, bh, (Aj, Bj, pj), (At, Bt, ptp), kw = _run(case, dtype, densify)
    assert pj.dense is not None and ptp.dense is not None
    _dense_fields_equal(pj.dense, ptp.dense)
    _staged_equal(pj, ptp, dtype)
    if case in ("banded_routes_dense", "pure_gather_emit",
                "gather_emit_multibatch"):
        assert ptp.dense.full_cover and not ptp.groups
        assert int(ptp.dense.valids.sum()) == ah.rows
    if case == "mixed_with_stream":
        assert ptp.stream.layout.n_stream_rows > 0
    if case == "ineligible_groupless_tile":
        assert not ptp.dense.full_cover
    if case == "outliers_clustered":
        assert int((ptp.dense.valids > 0).sum()) >= 12
    Ct = pt.device_get_csr(ptp.execute())
    Cj = st.device_get_csr(pj.execute())
    # the gather emit where the reference takes it, and in the pure cases
    assert calls["port"] == calls["jax"]
    if case in ("banded_routes_dense", "pure_gather_emit",
                "gather_emit_multibatch"):
        assert calls["port"] == 1
    if case in ("mixed_with_stream", "ineligible_groupless_tile"):
        assert calls["port"] == 0
    _assert_c(ah, bh, Cj, Ct, dtype)
    if case == "disabled_matches":
        off = dict(kw, enable_dense=False)
        Cs = pt.device_get_csr(pt.spgemm(At, At, pt.SpgemmConfig(**off)))
        _eq(Ct.row_offsets, Cs.row_offsets)
        _eq(Ct.col_ids, Cs.col_ids)
        np.testing.assert_allclose(Ct.data, Cs.data, rtol=1e-4, atol=1e-6)
    if case in ("reexecute_new_values", "pure_gather_emit"):
        # replay with new values: the scatter emit over recomputed tiles
        h2 = st.HostCSR(ah.rows, ah.cols, ah.row_offsets, ah.col_ids,
                        ah.data * -3.0)
        A2j, A2t = _put(h2, dtype)
        Ct2 = pt.device_get_csr(ptp.execute(A2t, A2t))
        Cj2 = st.device_get_csr(pj.execute(A2j, A2j))
        _assert_c(h2, h2, Cj2, Ct2, dtype)
        _eq(Ct2.col_ids, Ct.col_ids)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_densify_forms_equal(dtype):
    """_densify_sorted (two K2 passes) and _densify_scatter give the same
    window and hit planes as a plain numpy scatter, including negative
    and past-the-window slots (dropped)."""
    rs = np.random.RandomState(3)
    R, L, W = 24, 8, 40
    loc = np.stack([np.sort(rs.choice(np.arange(-6, W + 6), L,
                                      replace=False)) for _ in range(R)])
    val = rs.standard_normal((R, L)).astype(dtype)
    want = np.zeros((R, W), dtype)
    hit = np.zeros((R, W), bool)
    for r in range(R):
        for j in range(L):
            if 0 <= loc[r, j] < W:
                want[r, loc[r, j]] = val[r, j]
                hit[r, loc[r, j]] = True
    lt, vt = torch.from_numpy(loc.astype(np.int32)), torch.from_numpy(val)
    for fn in (tdense._densify_sorted, tdense._densify_scatter):
        d, h = fn(lt, vt, W)
        _eq(h.numpy(), hit, fn.__name__)
        _eq(d.numpy(), want, fn.__name__)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_row_blocked_call_takes_tiles(dtype, request, monkeypatch):
    """Past block_products, spgemm runs row blocks, and each block takes
    the dense tiles, as the reference's does (JAX's row-blocked call
    compiles once per block, so its single plan is the yardstick)."""
    if dtype == np.float64:
        request.getfixturevalue("x64")
    rs = np.random.RandomState(12)
    a = _banded(96, 3, rs)
    ah = st.HostCSR.from_scipy(a)
    Aj, At = _put(ah, dtype)
    kw = dict(_DENSE_KW, block_products=600)
    plans = []
    real = tsp.plan_spgemm

    def counting(*args, **kwargs):
        plans.append(real(*args, **kwargs))
        return plans[-1]

    monkeypatch.setattr(tsp, "plan_spgemm", counting)
    Ct = pt.device_get_csr(pt.spgemm(At, At, pt.SpgemmConfig(**kw)))
    assert len(plans) >= 2 and all(p.dense is not None for p in plans)
    pj = st.plan_spgemm(Aj, Aj, st.SpgemmConfig(**_DENSE_KW))
    assert pj.dense is not None
    _assert_c(ah, ah, st.device_get_csr(pj.execute()), Ct, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_hostless_device_csr_takes_tiles(dtype, request):
    """A DeviceCSR made on the device (no host copy attached, so no host
    pre-reject) takes the tiles the planning pass counts, in both
    packages, with equal groups and results."""
    if dtype == np.float64:
        request.getfixturevalue("x64")
    rs = np.random.RandomState(13)
    a = _banded(96, 3, rs)
    ah = st.HostCSR.from_scipy(a)
    Aj0, At0 = _put(ah, dtype)
    Aj = st.DeviceCSR(indptr=Aj0.indptr, indices=Aj0.indices,
                      data=Aj0.data, shape=Aj0.shape, nnz=Aj0.nnz,
                      canonical=True)
    At = pt.DeviceCSR(indptr=At0.indptr, indices=At0.indices,
                      data=At0.data, shape=At0.shape, nnz=At0.nnz,
                      canonical=True)
    assert tsp.host_of(At) is None
    pj = st.plan_spgemm(Aj, Aj, st.SpgemmConfig(**_DENSE_KW))
    ptp = pt.plan_spgemm(At, At, pt.SpgemmConfig(**_DENSE_KW))
    assert ptp.dense is not None and ptp.stream.dense_elig > 0
    _dense_fields_equal(pj.dense, ptp.dense)
    _staged_equal(pj, ptp, dtype)
    _assert_c(ah, ah, st.device_get_csr(pj.execute()),
              pt.device_get_csr(ptp.execute()), dtype)


def test_dense_emit_trims_to_the_widest_row():
    """max_count (read back with nnz) trims the emit width: the plan's
    max_count is the widest row of C and equals the reference's."""
    rs = np.random.RandomState(14)
    a = _banded(96, 3, rs)
    ah = st.HostCSR.from_scipy(a)
    Aj, At = _put(ah, np.float32)
    pj = st.plan_spgemm(Aj, Aj, st.SpgemmConfig(**_DENSE_KW))
    ptp = pt.plan_spgemm(At, At, pt.SpgemmConfig(**_DENSE_KW))
    assert ptp.max_count == pj.max_count == int(np.diff(
        np.asarray(ptp.row_offsets)).max())
