"""The port's dense-span accumulator against speck_tpu on the CPU.

The two accumulator cases of tests/test_stream.py (a huge row of bounded
output span beside short rows, and three hot rows split into parts by a
tiny accum_budget) run through both packages with enable_accum=True on the
same seeded input, made with numpy. Held equal: n_accum, the parts (row
ranges, slots, span classes and their rows), abase and cmin_s, the
planning pack, and C's row offsets and column ids, which also equal the
accumulator-off run's.
Tolerances: values within rtol 2e-3 of JAX's and of the scipy oracle in
float32 (the reference's own tolerance; the scatter-adds sum in another
order, and on the card in an order that changes between launches); in
float64 within 1e-12 of JAX's (JAX under ``jax_enable_x64``, restored
after the test) and 1e-9 of the oracle."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu_torch.ops import stream as tstream

JAX_TOL = {np.float32: 2e-3, np.float64: 1e-12}
ORACLE_TOL = {np.float32: 2e-3, np.float64: 1e-9}
N_Q = tstream.N_QCLASS
_BASE = dict(product_budget=1 << 14, enable_dense=False)


@pytest.fixture()
def x64():
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _giant_span():
    """tests/test_stream.py:467's input: row 0 references 60 heavy rows of
    40 entries each, all inside a 120-column span; 79 short rows."""
    m = 500
    rs = np.random.RandomState(3)
    heavy = np.arange(100, 160)
    hr = np.repeat(heavy, 40)
    hc = (np.tile(np.arange(40), 60) * 3) % 120 + 300
    lr = np.repeat(np.arange(1, 80), 4)
    lc = rs.randint(0, 250, lr.shape[0])
    rows = np.concatenate([np.zeros(60, int), hr, lr])
    cols = np.concatenate([heavy, hc, lc])
    g = sp.csr_matrix((rs.standard_normal(rows.shape[0]), (rows, cols)),
                      shape=(m, m))
    g.sum_duplicates()
    return g, dict(accum_min_ops=512, accum_span_cap=1 << 10,
                   stream_width=256, product_budget=1 << 12)


def _multi_part():
    """tests/test_stream.py:508's input: three hot rows with disjoint
    bounded spans, one accumulator part each under accum_budget 80."""
    rs = np.random.RandomState(7)
    segs = []
    for i, base in enumerate((200, 240, 280)):
        heavy = np.arange(50 + i * 20, 70 + i * 20)
        segs.append((np.full(20, i), heavy, rs.standard_normal(20)))
        hr = np.repeat(heavy, 30)
        hc = (np.tile(np.arange(30), 20) * 2) % 36 + base
        segs.append((hr, hc, rs.standard_normal(hr.shape[0])))
    rows = np.concatenate([s[0] for s in segs])
    cols = np.concatenate([s[1] for s in segs])
    vals = np.concatenate([s[2] for s in segs])
    g = sp.csr_matrix((vals, (rows, cols)), shape=(400, 400))
    g.sum_duplicates()
    return g, dict(accum_min_ops=256, accum_span_cap=1 << 9,
                   accum_budget=80, stream_width=128,
                   product_budget=1 << 11)


CASES = {"giant_span": _giant_span, "multi_part": _multi_part}


def _put(h, dtype):
    return (st.device_put_csr(h, dtype),
            pt.device_put_csr(pt.HostCSR.from_host(h), dtype, device="cpu"))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _assert_c(h, Cj, Ct, dtype):
    _eq(np.asarray(Ct.row_offsets, np.int64),
        np.asarray(Cj.row_offsets, np.int64), "row offsets")
    _eq(np.asarray(Ct.col_ids, np.int64), np.asarray(Cj.col_ids, np.int64),
        "column ids")
    assert Ct.data.dtype == np.dtype(dtype)
    tol = JAX_TOL[dtype]
    np.testing.assert_allclose(Ct.data, Cj.data, rtol=tol, atol=tol * 1e-1)
    ht = pt.HostCSR.from_host(h)
    r = pt.compare_csr(pt.oracle_spgemm(ht, ht), Ct, compare_data=True,
                       rel_tol=ORACLE_TOL[dtype])
    assert r.ok, r.message


def _accum_plan_equal(sj, stt):
    assert stt.n_accum == sj.n_accum > 0
    _eq(stt.abase, sj.abase, "abase")
    _eq(stt.cmin_s, sj.cmin_s, "cmin_s")
    _eq(stt.rec2.e, sj.e2, "e2")
    for f in ("p0", "su", "pend", "src"):
        _eq(getattr(stt.rec2, f), getattr(sj, f + "2"), f + "2")
    pj_, pt_ = sj.accum["parts"], stt.accum["parts"]
    assert len(pt_) == len(pj_)
    for a, b in zip(pj_, pt_):
        for f in ("row_lo", "row_hi", "slots"):
            assert b[f] == a[f], f
        assert len(b["classes"]) == len(a["classes"])
        for (R, S, off, rid), (Rt, St, offt, ridt) in zip(a["classes"],
                                                          b["classes"]):
            assert (Rt, St, offt) == (R, S, off)
            _eq(ridt, rid, "rid_of_out")


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(CASES))
def test_accum_matches_jax(case, dtype, request):
    """The accumulator plan fields equal JAX's; C equal in structure to
    JAX's and to the accumulator-off run's, values within tolerance; then
    replay with new values through the accumulator."""
    if dtype == np.float64:
        request.getfixturevalue("x64")
    g, kw = CASES[case]()
    kw = dict(_BASE, enable_accum=True, **kw)
    h = st.HostCSR.from_scipy(g)
    Aj, At = _put(h, dtype)
    pj = st.plan_spgemm(Aj, Aj, st.SpgemmConfig(**kw))
    ptp = pt.plan_spgemm(At, At, pt.SpgemmConfig(**kw))
    _accum_plan_equal(pj.stream, ptp.stream)
    if case == "giant_span":
        assert ptp.stream.n_accum == 1
    else:
        assert ptp.stream.n_accum == 3 and len(ptp.stream.accum["parts"]) >= 2
    for f in ("rows_sorted", "e", "el", "ops_sorted"):
        _eq(getattr(ptp.stream, f), getattr(pj.stream, f), f)
    assert ptp.nnz == pj.nnz and ptp.max_count == pj.max_count
    Ct = pt.device_get_csr(ptp.execute())
    _assert_c(h, st.device_get_csr(pj.execute()), Ct, dtype)
    # the same structure with the accumulator off
    off = pt.device_get_csr(pt.spgemm(At, At, pt.SpgemmConfig(
        **dict(kw, enable_accum=False))))
    _eq(Ct.row_offsets, off.row_offsets)
    _eq(Ct.col_ids, off.col_ids)
    # replay with new values
    h2 = st.HostCSR(h.rows, h.cols, h.row_offsets, h.col_ids, h.data * -2.0)
    A2j, A2t = _put(h2, dtype)
    Ct2 = pt.device_get_csr(ptp.execute(A2t, A2t))
    _assert_c(h2, st.device_get_csr(pj.execute(A2j, A2j)), Ct2, dtype)


@pytest.mark.parametrize("case", list(CASES))
def test_accum_planning_pack_equal(case):
    """plan_device_stream with use_accum: the whole pack (the accumulator
    class histogram, its product sums, n_live_slots_accum), the row order,
    e2, q2 and cmin_sorted equal JAX's."""
    from speck_tpu.ops import stream as jstream
    import jax.numpy as jnp

    g, kw = CASES[case]()
    h = st.HostCSR.from_scipy(g)
    ip = np.asarray(h.row_offsets, np.int32)
    ix = np.asarray(h.col_ids, np.int32)
    a32 = np.asarray(h.data, np.float32).view(np.int32)
    row_ops = st.ops.analysis.host_analyze(h, h).row_ops.astype(np.int32)
    m = h.rows
    akw = dict(use_accum=True, accum_min_ops=kw["accum_min_ops"],
               accum_span_cap=kw["accum_span_cap"])
    outj = jstream.plan_device_stream(
        *(jnp.asarray(x) for x in (ip, ix, a32, ip, ix, row_ops)), None,
        None, min_q=8, direct_ok=True, use_dense=False, tile_rows=256,
        kw_max=512, cw_max=512, la_max=64, lb_max=64, max_tiles=0, m=m,
        w0=kw["stream_width"], **akw)
    outt = tstream.plan_device_stream(
        *(torch.from_numpy(x) for x in (ip, ix, a32, ip, ix, row_ops)), None,
        None, min_q=8, direct_ok=True, m=m, w0=kw["stream_width"], **akw)
    _eq(outt[6], outj[14], "pack")
    assert int(outt[6][2 * N_Q: 3 * N_Q].sum()) > 0
    for i, name in enumerate(["rows_sorted", "e", "q_sorted", "el",
                              "ops_sorted"]):
        _eq(outt[i], outj[i], name)
    _eq(outt[12], outj[5], "e2")
    _eq(outt[13], outj[6], "q2_sorted")
    _eq(outt[14], outj[7], "cmin_sorted")


def test_accum_with_wide_and_direct_rows():
    """The accumulator region sorts first, ahead of wide stream rows and
    direct rows: their sorted ids shift by n_accum (the wide finish, the
    direct classes, the numeric emit), with plan fields equal to JAX's,
    fused and two-phase. C is held to the oracle: on this input the
    reference drops rows of its last, shorter chunk, whose record window
    it sizes by that chunk's own rows over uncompacted records; the port
    sizes it by the full chunk (stream.chunk_expand)."""
    rs = np.random.RandomState(21)
    g, kw = _giant_span()
    lil = g.tolil()
    # a wide stream row: 160 products over W = 64, below accum_min_ops
    lil[200, 1:80:2] = rs.standard_normal(40)
    for r in range(300, 320):               # single-nonzero rows (direct)
        lil[r, :] = 0
        lil[r, int(rs.randint(0, 500))] = 1.5
    g = lil.tocsr()
    g.eliminate_zeros()
    kw = dict(_BASE, enable_accum=True, **dict(kw, stream_width=64))
    h = st.HostCSR.from_scipy(g)
    ht = pt.HostCSR.from_host(h)
    ref = pt.oracle_spgemm(ht, ht)
    Aj, At = _put(h, np.float32)
    for fused in (True, False):
        k = dict(kw, fused_staging_budget=(1 << 28) if fused else 0)
        pj = st.plan_spgemm(Aj, Aj, st.SpgemmConfig(**k))
        ptp = pt.plan_spgemm(At, At, pt.SpgemmConfig(**k))
        assert ptp.stream.n_accum >= 1 and ptp.stream.layout.n_wide >= 1
        assert ptp.groups and ptp.stream.fused == fused
        assert ptp.stream.layout.g_last < ptp.stream.layout.G
        _accum_plan_equal(pj.stream, ptp.stream)
        for f in ("rows_sorted", "e"):
            _eq(getattr(ptp.stream, f), getattr(pj.stream, f), f)
        for f in ("p0", "su", "src", "pend"):
            _eq(getattr(ptp.stream.rec, f), getattr(pj.stream, f), f)
        assert ([g.valids.tolist() for g in ptp.groups]
                == [g.valids.tolist() for g in pj.groups])
        assert ([g.starts.tolist() for g in ptp.groups]
                == [g.starts.tolist() for g in pj.groups])
        r = pt.compare_csr(ref, pt.device_get_csr(ptp.execute()),
                           compare_data=True, rel_tol=ORACLE_TOL[np.float32])
        assert r.ok, r.message


@pytest.mark.parametrize("routes", ["all", "stream_only"])
@pytest.mark.parametrize("shape", [(130, 7, 257), (5, 3, 9)],
                         ids=["130x7x257", "5x3x9"])
def test_accum_with_b_without_nonzeros(shape, routes):
    """ROADMAP.md standing decision 12: with ``enable_accum=True`` and a B
    that has no nonzeros, the reference raises a TypeError
    (``speck_tpu/ops/stream.py:699-701`` gathers ``b_indices`` at
    ``b_indptr[:-1]`` from an empty ``b_indices``), for any A, with or
    without the DIA and dense routes. The port returns the empty m x n C:
    equal to the oracle and to the reference's result with the
    accumulator off."""
    m, k, n = shape
    rs = np.random.RandomState(5)
    a = sp.random(m, k, 0.4, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz)
    ha = st.HostCSR.from_scipy(a)
    hb = st.HostCSR.from_scipy(sp.csr_matrix((k, n)))
    kw = dict(enable_accum=True, accum_min_ops=16)
    if routes == "stream_only":
        kw.update(enable_dia=False, enable_sdia=False, dia_rows=False,
                  enable_dense=False)
    (Aj, At), (Bj, Bt) = _put(ha, np.float32), _put(hb, np.float32)
    Ct = pt.device_get_csr(pt.spgemm(At, Bt, pt.SpgemmConfig(**kw)))
    assert Ct.shape == (m, n) and Ct.nnz == 0
    r = pt.compare_csr(pt.oracle_spgemm(pt.HostCSR.from_host(ha),
                                        pt.HostCSR.from_host(hb)),
                       Ct, compare_data=True)
    assert r.ok, r.message
    with pytest.raises(TypeError):
        st.spgemm(Aj, Bj, st.SpgemmConfig(**kw))
    Cj = st.device_get_csr(st.spgemm(Aj, Bj, st.SpgemmConfig(
        **dict(kw, enable_accum=False))))
    _eq(np.asarray(Ct.row_offsets, np.int64),
        np.asarray(Cj.row_offsets, np.int64), "row offsets")
    assert Cj.nnz == 0 and Ct.data.dtype == np.float32
