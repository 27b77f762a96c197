"""The diagonal-plane routes of the port (contiguous DIA, sparse DIA and
the per-row DIA split) against speck_tpu on the CPU.

Every function of ``speck_tpu_torch/ops/dia.py`` and ``dense_gather_emit``
is held to its JAX counterpart on seeded inputs made with numpy: integers
equal, values within rtol 1e-5 (float32) or 1e-12 (float64). Then the
routes end to end under the default ``SpgemmConfig()`` unless a case says
otherwise: both packages must take the same route with equal plan fields,
``row_offsets`` and ``col_ids``, values within the same tolerances of
JAX's and within rel_tol 2e-3 of the scipy oracle. float64 runs JAX under
``jax_enable_x64``, restored after the test."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu.ops import dense as jdense
from speck_tpu.ops import dia as jdia
from speck_tpu.ops import stream as jstream
from speck_tpu_torch.ops import dense as tdense
from speck_tpu_torch.ops import dia as tdia
from speck_tpu_torch.ops import stream as tstream
from speck_tpu_torch.utils import generators as gen

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture()
def x64():
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _band(n, offs, rs, m=None):
    return sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                    shape=(m or n, n), format="csr")


def _diag_mat(m, k, offs, rs):
    rows, cols = [], []
    for o in offs:
        r = np.arange(max(0, -o), min(m, k - o))
        rows.append(r)
        cols.append(r + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((rs.standard_normal(rows.size), (rows, cols)),
                         shape=(m, k))


def _stencil(g, seed=3):
    return gen.make_stencil27(g, seed=seed).to_scipy()


def _powerlaw():
    """The unstructured input of every case that must stream: a small
    power-law matrix (bench configs 2 and 3 in miniature)."""
    return gen.make_powerlaw(1500, avg=6, seed=23).to_scipy()


def _mixed(n=2048, half=4, n_out=24, out_nnz=12, seed=3):
    return gen.make_mixed(n, half, n_out, out_nnz, seed=seed).to_scipy()


def _close(got, want, dtype=np.float32):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL[dtype], atol=RTOL[dtype] * 1e-1)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# Functions of ops/dia.py and dense_gather_emit against speck_tpu
# ---------------------------------------------------------------------------


def _csr_pair(a):
    a = a.tocsr()
    ip, ix = a.indptr.astype(np.int32), a.indices.astype(np.int32)
    return (jnp.asarray(ip), jnp.asarray(ix)), (torch.from_numpy(ip),
                                                torch.from_numpy(ix))


@pytest.mark.parametrize("masked", [False, True])
def test_dia_slots_and_row_inband(masked):
    rs = np.random.RandomState(1)
    a = _band(300, range(-3, 4), rs).tolil()
    a[40, :] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    (ipj, ixj), (ipt, ixt) = _csr_pair(a)
    keep = rs.rand(300) > 0.3
    kw = dict(dmin=-3, span=7, rows=300, masked=masked)
    got = tdia.dia_slots(ipt, ixt, torch.from_numpy(keep), **kw)
    want = jdia.dia_slots(ipj, ixj, jnp.asarray(keep), **kw)
    assert got.dtype == torch.int32
    _eq(got, want)
    for dmin, dmax in [(-3, 3), (-2, 3), (-3, 1)]:
        _eq(tdia.dia_row_inband(ipt, ixt, dmin=dmin, dmax=dmax),
            jdia.dia_row_inband(ipj, ixj, dmin=dmin, dmax=dmax))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_planes_and_conv(dtype, x64):
    rs = np.random.RandomState(2)
    m, k = 200, 230
    a = _diag_mat(m, k, range(-2, 4), rs)
    b = _diag_mat(k, 210, range(1, 5), rs)
    (aip, aix), (tip, tix) = _csr_pair(a)
    (bip, bix), (uip, uix) = _csr_pair(b)
    sa, sb, dmin_a, dmin_b = 6, 4, -2, 1
    sl_j = jdia.dia_slots(aip, aix, dmin=dmin_a, span=sa, rows=m)
    sl_t = tdia.dia_slots(tip, tix, dmin=dmin_a, span=sa, rows=m)
    sb_j = jdia.dia_slots(bip, bix, dmin=dmin_b, span=sb, rows=k)
    sb_t = tdia.dia_slots(uip, uix, dmin=dmin_b, span=sb, rows=k)
    ad, bd = a.data.astype(dtype), b.data.astype(dtype)
    pj = jdia.dia_planes(sl_j, jnp.asarray(ad), span=sa, rows=m)
    pt_ = tdia.dia_planes(sl_t, torch.from_numpy(ad), span=sa, rows=m)
    _eq(pt_[0], pj[0])
    _eq(pt_[1], pj[1])
    qj = jdia.dia_planes(sb_j, jnp.asarray(bd), span=sb, rows=k)
    qt = tdia.dia_planes(sb_t, torch.from_numpy(bd), span=sb, rows=k)
    kw = dict(sa=sa, sb=sb, m=m, k=k, dmin_a=dmin_a)
    for with_hit in (True, False):
        cj = jdia.dia_conv(*pj, *qj, with_hit=with_hit, **kw)
        ct = tdia.dia_conv(*pt_, *qt, with_hit=with_hit, **kw)
        assert ct[0].dtype == pt_[0].dtype
        _close(ct[0], cj[0], dtype)
        if with_hit:
            _eq(ct[1], cj[1])
        else:
            assert ct[1] is None
    # the fused forms: same planes, same convolution
    cj = jdia.dia_rows_conv_fused(sl_j, jnp.asarray(ad), sb_j,
                                  jnp.asarray(bd), with_hit=True, **kw)
    ct = tdia.dia_rows_conv_fused(sl_t, torch.from_numpy(ad), sb_t,
                                  torch.from_numpy(bd), with_hit=True, **kw)
    _close(ct[0], cj[0], dtype)
    _eq(ct[1], cj[1])
    sc = sa + sb - 1
    outj = jdia.dia_count_pipeline(
        sl_j, jnp.asarray(ad), sb_j, jnp.asarray(bd), sc=sc, n_cols=210,
        base_c=dmin_a + dmin_b, impl="sort", same=False, **kw)
    outt = tdia.dia_count_pipeline(
        sl_t, torch.from_numpy(ad), sb_t, torch.from_numpy(bd), sc=sc,
        n_cols=210, base_c=dmin_a + dmin_b, same=False, **kw)
    _eq(outt[0], outj[0])
    _eq(outt[1], outj[1])
    live = np.asarray(outj[1]).sum(1)[:, None] > np.arange(sc)[None, :]
    _eq(outt[2].numpy()[live], np.asarray(outj[2])[live])
    _close(outt[3].numpy()[live], np.asarray(outj[3])[live], dtype)


def _staging_inputs(dtype, m=64, sc=9, seed=3):
    rs = np.random.RandomState(seed)
    present = rs.rand(m, sc) > 0.4
    present[5:40] = True                     # a full run, broken at 20
    present[20, 3] = False
    c_val = (rs.standard_normal((sc, m)) * present.T).astype(dtype)
    c_cnt = (present.T * rs.randint(1, 4, (sc, m))).astype(np.float32)
    return present, c_val, c_cnt


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sparse", [False, True])
def test_rank_compaction_equals_the_sort_arm(dtype, sparse, x64):
    """The port's one scatter equals JAX's rank sort on every slot that is
    emitted (the first count slots of a row) and its scatter arm on every
    slot."""
    present, c_val, c_cnt = _staging_inputs(dtype)
    m, sc = present.shape
    doffs = np.array([-40, -7, -1, 0, 2, 3, 9, 30, 77], np.int32)
    dj = jnp.asarray(doffs) if sparse else None
    dt = torch.from_numpy(doffs) if sparse else None
    base_c = 0 if sparse else -4
    kw = dict(sc=sc, m=m, n_cols=500, base_c=base_c)
    cj = jdia.dia_count_stage(jnp.asarray(c_val), jnp.asarray(c_cnt), dj,
                              impl="sort", **kw)
    ct = tdia.dia_count_stage(torch.from_numpy(c_val),
                              torch.from_numpy(c_cnt), dt, **kw)
    _eq(ct[0], cj[0])
    _eq(ct[1], cj[1])
    live = np.asarray(cj[0])[:, None] > np.arange(sc)[None, :]
    _eq(ct[2].numpy()[live], np.asarray(cj[2])[live])
    _eq(ct[3].numpy()[live], np.asarray(cj[3])[live])
    scat = jdia.dia_count_stage(jnp.asarray(c_val), jnp.asarray(c_cnt), dj,
                                impl="scatter", **kw)
    _eq(ct[2], scat[2])
    _eq(ct[3], scat[3])
    # the numeric stage against a stored structure
    nj = jdia.dia_numeric_stage(jnp.asarray(c_val), jnp.asarray(present), dj,
                                impl="sort", **kw)
    nt = tdia.dia_numeric_stage(torch.from_numpy(c_val),
                                torch.from_numpy(present), dt, **kw)
    _eq(nt[0].numpy()[live], np.asarray(nj[0])[live])
    _eq(nt[1].numpy()[live], np.asarray(nj[1])[live])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_offsets_meta_and_emits(dtype, x64):
    present, c_val, c_cnt = _staging_inputs(dtype)
    m, sc = present.shape
    kw = dict(sc=sc, m=m, n_cols=500, base_c=-4)
    _, _, cols_j, vals_j = jdia.dia_count_stage(
        jnp.asarray(c_val), jnp.asarray(c_cnt), impl="sort", **kw)
    counts_t, _, cols_t, vals_t = tdia.dia_count_stage(
        torch.from_numpy(c_val), torch.from_numpy(c_cnt), **kw)
    oj, mj = jdia.dia_offsets_meta(jnp.asarray(counts_t.numpy()), sc=sc)
    ot, mt = tdia.dia_offsets_meta(counts_t, sc=sc)
    _eq(ot, oj)
    _eq(mt, mj)
    nnz, _, up, uq, run_ok, u_offs = (int(x) for x in mt)
    assert run_ok == 0 and uq - up > 30     # row 20 breaks the run
    for r0, r1 in [(0, up), (uq, m), (0, m), (7, 8)]:
        o0, o1 = int(ot[r0]), int(ot[r1])
        ej = jdia.dia_emit_edge(cols_j, vals_j, oj, sc=sc, r0=r0, r1=r1,
                                o0=o0, n_out=o1 - o0)
        et = tdia.dia_emit_edge(cols_t, vals_t, ot, sc=sc, r0=r0, r1=r1,
                                o0=o0, n_out=o1 - o0)
        _eq(et[0], ej[0])
        _eq(et[1], ej[1])
    gj = jdense.dense_gather_emit(cols_j, vals_j, oj, tile_rows=1, cw=sc,
                                  m=m, nnz=nnz)
    gt = tdense.dense_gather_emit(cols_t, vals_t, ot, tile_rows=1, cw=sc,
                                  m=m, nnz=nnz)
    _eq(gt[0], gj[0])
    _eq(gt[1], gj[1])
    # the per-row split's scatter into a shared C: the other rows'
    # slots keep what the buffer held
    keep = np.ones(m, bool)
    keep[::3] = False
    pres = present & keep[:, None]
    offs = np.concatenate([[0], np.cumsum(present.sum(1))]).astype(np.int32)
    fill_c = np.full(nnz, -5, np.int32)
    fill_v = np.full(nnz, 0.5, dtype)
    sj = jdia.dia_scatter_emit(jnp.asarray(c_val.T), jnp.asarray(pres),
                               jnp.asarray(offs), jnp.asarray(fill_c),
                               jnp.asarray(fill_v), base_c=-4)
    st_ = tdia.dia_scatter_emit(
        torch.from_numpy(np.ascontiguousarray(c_val.T)),
        torch.from_numpy(pres), torch.from_numpy(offs),
        torch.from_numpy(np.append(fill_c, 0).astype(np.int32)),
        torch.from_numpy(np.append(fill_v, 0).astype(dtype)), base_c=-4)
    _eq(st_[0][:nnz], sj[0])
    _eq(st_[1][:nnz], sj[1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sdia_functions(dtype, request):
    """sdia_lut, sdia_slots, sdia_pad, the byte counts, and the port's
    whole-matrix sdia_conv against JAX's row-blocked form at row_block=128
    (with a padded tail block) in float32, and against JAX's whole form in
    float64 (the blocked form's offsets do not trace under x64)."""
    if dtype == np.float64:
        request.getfixturevalue("x64")
    rs = np.random.RandomState(7)
    m, k = 300, 290
    off_a, off_b = (-9, -1, 0, 2, 11), (-4, 0, 5)
    off_c = tuple(sorted({x + y for x in off_a for y in off_b}))
    a = _diag_mat(m, k, off_a, rs)
    (ipj, ixj), (ipt, ixt) = _csr_pair(a)
    lut = jdia.sdia_lut(np.array(off_a), -9, 21)
    _eq(tdia.sdia_lut(np.array(off_a), -9, 21), lut)
    _eq(tdia.sdia_slots(ipt, ixt, torch.from_numpy(lut), dmin=-9, rows=m),
        jdia.sdia_slots(ipj, ixj, jnp.asarray(lut), dmin=-9, rows=m))
    assert tdia.sdia_pad(off_a, m, k) == jdia.sdia_pad(off_a, m, k)
    assert (tdia.sdia_plane_bytes(m, k, 5, 3, 15, 320, 8)
            == jdia.sdia_plane_bytes(m, k, 5, 3, 15, 320, 8))
    assert (tdia.plane_bytes(m, k, 40, 7, 5, 8)
            == jdia.plane_bytes(m, k, 40, 7, 5, 8))
    av = rs.standard_normal((len(off_a), m)).astype(dtype)
    ah = (rs.rand(len(off_a), m) > 0.3).astype(np.float32)
    bv = rs.standard_normal((len(off_b), k)).astype(dtype)
    bh = (rs.rand(len(off_b), k) > 0.3).astype(np.float32)
    kw = dict(off_a=off_a, off_b=off_b, off_c=off_c, m=m, k=k)
    for with_hit in (True, False):
        jargs = [jnp.asarray(x) for x in (av, ah, bv, bh)]
        if dtype == np.float32:
            cj = jdia.sdia_conv_blocked(*jargs, with_hit=with_hit,
                                        row_block=128, **kw)
        else:
            cj = jdia.sdia_conv(*jargs, with_hit=with_hit, **kw)
        ct = tdia.sdia_conv(*(torch.from_numpy(x) for x in (av, ah, bv, bh)),
                            with_hit=with_hit, **kw)
        _close(ct[0], cj[0], dtype)
        if with_hit:
            _eq(ct[1], cj[1])


# ---------------------------------------------------------------------------
# Routes end to end
# ---------------------------------------------------------------------------

_DIA_FIELDS = ("span_a", "span_b", "span_c", "dmin_a", "dmin_b", "uniform",
               "off_a", "off_b")
_DIA_ARRAYS = ("slot_a", "slot_b", "present", "doffs")


def _put(h, dtype):
    return (st.device_put_csr(h, dtype),
            pt.device_put_csr(pt.HostCSR.from_host(h), dtype, device="cpu"))


def _run_both(a, b=None, kw=None, dtype=np.float32, new_values=False):
    """Plan and execute in both packages; check the route, the plan
    fields, the output against JAX and the oracle. Returns the plans."""
    kw = kw or {}
    ah = st.HostCSR.from_scipy(a)
    bh = ah if b is None else st.HostCSR.from_scipy(b)
    Aj, At = _put(ah, dtype)
    Bj, Bt = (Aj, At) if b is None else _put(bh, dtype)
    pj = st.plan_spgemm(Aj, Bj, st.SpgemmConfig(**kw))
    ptp = pt.plan_spgemm(At, Bt, pt.SpgemmConfig(**kw))
    assert (ptp.dia is None) == (pj.dia is None)
    assert (ptp.dia_rows is None) == (pj.dia_rows is None)
    if pj.dia is not None:
        for f in _DIA_FIELDS:
            assert getattr(ptp.dia, f) == getattr(pj.dia, f), f
        for f in _DIA_ARRAYS:
            if getattr(pj.dia, f) is not None:
                _eq(getattr(ptp.dia, f), getattr(pj.dia, f), f)
        assert ptp.max_count == pj.max_count
    if pj.dia_rows is not None:
        for f in ("span_a", "span_b", "span_c", "dmin_a", "dmin_b"):
            assert getattr(ptp.dia_rows, f) == getattr(pj.dia_rows, f), f
        for f in ("slot_a", "slot_b", "present"):
            _eq(getattr(ptp.dia_rows, f), getattr(pj.dia_rows, f), f)
    assert ptp.nnz == pj.nnz
    _eq(ptp.row_offsets, pj.row_offsets)
    runs = [(ah, bh, (), ())]
    if new_values:
        def scaled(h):
            return st.HostCSR(rows=h.rows, cols=h.cols,
                              row_offsets=h.row_offsets, col_ids=h.col_ids,
                              data=h.data * -1.5 + 0.125)
        ah2 = scaled(ah)
        bh2 = ah2 if b is None else scaled(bh)
        Aj2, At2 = _put(ah2, dtype)
        Bj2, Bt2 = (Aj2, At2) if b is None else _put(bh2, dtype)
        runs.append((ah2, bh2, (Aj2, Bj2), (At2, Bt2)))
    for h1, h2, argj, argt in runs:
        Cj = st.device_get_csr(pj.execute(*argj))
        Ct = pt.device_get_csr(ptp.execute(*argt))
        _eq(np.asarray(Ct.row_offsets, np.int64),
            np.asarray(Cj.row_offsets, np.int64))
        _eq(np.asarray(Ct.col_ids, np.int64), np.asarray(Cj.col_ids, np.int64))
        assert Ct.data.dtype == np.dtype(dtype)
        _close(Ct.data, Cj.data, dtype)
        r = pt.compare_csr(pt.oracle_spgemm(pt.HostCSR.from_host(h1),
                                            pt.HostCSR.from_host(h2)),
                           Ct, compare_data=True, rel_tol=2e-3)
        assert r.ok, r.message
    return pj, ptp


def _rect():
    rs = np.random.RandomState(3)
    a = sp.diags([rs.standard_normal(200)] * 6, list(range(6)),
                 shape=(200, 260), format="csr")
    b = sp.diags([rs.standard_normal(240)] * 5, list(range(-2, 3)),
                 shape=(260, 240), format="csr")
    return a, b


def _explicit_zero():
    a = _band(120, range(-2, 3), np.random.RandomState(4)).tocsr()
    a.data[7] = 0.0
    return a, None


def _mixed_ops():
    rs = np.random.RandomState(2)
    return _band(300, range(-2, 3), rs), _band(300, range(1, 5), rs)


DIA_CASES = {
    "banded": lambda: (_band(300, range(-3, 4), np.random.RandomState(0)),
                       None),
    "off_diagonal": lambda: (_band(300, [10, 11, 12],
                                   np.random.RandomState(1)), None),
    "a_ne_b": _mixed_ops,
    "rectangular": _rect,
    "explicit_zero": _explicit_zero,
    "identity": lambda: (sp.eye(64, format="csr"), None),
}


@pytest.mark.parametrize("case", list(DIA_CASES))
def test_dia_route_matches_jax(case):
    a, b = DIA_CASES[case]()
    pj, ptp = _run_both(a, b)
    assert ptp.dia is not None and ptp.dia.off_a is None


SDIA_CASES = {
    "stencil2d": lambda: (_diag_mat(576, 576, [-24, -1, 0, 1, 24],
                                    np.random.RandomState(21)), None),
    "mixed_offsets": lambda: (
        _band(500, [-7, 0, 3], np.random.RandomState(22)),
        _band(500, [-40, 1, 90], np.random.RandomState(23))),
    "rectangular": lambda: (
        _diag_mat(300, 280, [-30, 0, 17], np.random.RandomState(25)),
        _diag_mat(280, 320, [0, 9, -55], np.random.RandomState(26))),
    "waste_gate": lambda: (_band(400, [0, 200], np.random.RandomState(6)),
                           None),
}


@pytest.mark.parametrize("case", list(SDIA_CASES))
def test_sdia_route_matches_jax(case):
    a, b = SDIA_CASES[case]()
    pj, ptp = _run_both(a, b)
    assert ptp.dia is not None and ptp.dia.off_a is not None


@pytest.mark.parametrize("mat,kw,route", [
    # the contiguous waste gate rejects a sparse band; without sparse DIA
    # it streams
    ("sparse_band", dict(enable_sdia=False), "stream"),
    # the span cap rejects the band: sparse DIA takes it, or the stream
    ("band", dict(dia_span_cap=4), "sdia"),
    ("band", dict(dia_span_cap=4, enable_sdia=False, sdia_span_cap=4),
     "stream"),
    ("band", dict(enable_dia=False), "stream"),
    # the pair cap rejects sparse DIA
    ("band", dict(sdia_pair_cap=1, dia_span_cap=4), "stream"),
])
def test_gates_reject_like_jax(mat, kw, route):
    rs = np.random.RandomState(6)
    a = (_band(400, [0, 200], rs) if mat == "sparse_band"
         else _band(300, range(-3, 4), rs))
    pj, ptp = _run_both(a, kw=dict(kw, enable_dense=False))
    got = ("stream" if ptp.dia is None
           else "sdia" if ptp.dia.off_a is not None else "dia")
    assert got == route
    if route == "stream":
        assert ptp.stream is not None and ptp.stream.layout.n_stream_rows


def test_noncanonical_and_unstructured_inputs_stream():
    rs = np.random.RandomState(9)
    a = _band(150, range(-2, 3), rs).tocsr()
    ah = st.HostCSR.from_scipy(a)
    for i in range(ah.rows):    # reverse each row: not canonical
        s, e = ah.row_offsets[i], ah.row_offsets[i + 1]
        ah.col_ids[s:e] = ah.col_ids[s:e][::-1].copy()
        ah.data[s:e] = ah.data[s:e][::-1].copy()
    At = pt.device_put_csr(pt.HostCSR.from_host(ah), device="cpu")
    assert not At.canonical
    plan = pt.plan_spgemm(At, At)
    assert plan.dia is None and plan.dia_rows is None
    assert st.plan_spgemm(*(st.device_put_csr(ah),) * 2).dia is None
    r = pt.compare_csr(pt.oracle_spgemm(pt.HostCSR.from_host(ah),
                                        pt.HostCSR.from_host(ah)),
                       pt.device_get_csr(plan.execute()), compare_data=True,
                       rel_tol=2e-3)
    assert r.ok, r.message
    pj, ptp = _run_both(_powerlaw())
    assert ptp.dia is None and ptp.dia_rows is None


@pytest.mark.parametrize("early", [True, False])
@pytest.mark.parametrize("kind", ["banded", "sparse_band"])
def test_early_gate_on_and_off(early, kind):
    """Without the host analysis the device gates decide: the early gate's
    readback, or the planning pack's late gate."""
    rs = np.random.RandomState(12)
    a = (_band(300, range(-3, 4), rs) if kind == "banded"
         else _band(400, [0, 200], rs))
    pj, ptp = _run_both(a, kw=dict(dia_gate_early=early, host_analysis=False,
                                   enable_dense=False))
    assert (ptp.dia is not None) == (kind == "banded")


def test_uniform_emit_taken_and_broken_run():
    rs = np.random.RandomState(21)
    a = _band(500, range(-3, 4), rs)
    pj, ptp = _run_both(a)
    assert ptp.dia.uniform == (6, 494, int(ptp.row_offsets[6]))
    off = _run_both(a, kw=dict(dia_uniform_emit=False))[1]
    assert off.dia.uniform is None
    c_on = pt.device_get_csr(ptp.execute())
    c_off = pt.device_get_csr(off.execute())
    _eq(c_on.col_ids, c_off.col_ids)
    _eq(c_on.data, c_off.data)
    b = _band(400, range(-2, 3), rs).tolil()
    b[200, :] = 0                    # C row 200 empty: the run breaks
    b = b.tocsr()
    b.eliminate_zeros()
    assert _run_both(b)[1].dia.uniform is None


@pytest.mark.parametrize("route", ["dia", "dia_a_ne_b", "sdia"])
def test_plan_reuse_with_new_values(route):
    rs = np.random.RandomState(5)
    if route == "dia":
        a, b = _band(200, range(-2, 3), rs), None
    elif route == "dia_a_ne_b":
        a, b = _mixed_ops()
    else:
        a, b = _diag_mat(256, 256, [-16, -1, 0, 1, 16], rs), None
    pj, ptp = _run_both(a, b, new_values=True)
    assert ptp.dia is not None


def test_stencil_through_the_lite_gate():
    """Past host_analysis_max_nnz the lite host gate and the device
    diagonal bitmap route the stencil to sparse DIA, a band to DIA, and
    reject a random input."""
    kw = dict(host_analysis_max_nnz=16)
    pj, ptp = _run_both(_stencil(10), kw=kw)
    assert ptp.dia.off_a is not None and ptp.dia.span_a == 27
    rs = np.random.RandomState(3)
    pj, ptp = _run_both(_band(512, range(-3, 4), rs), kw=kw)
    assert ptp.dia is not None and ptp.dia.off_a is None
    pj, ptp = _run_both(_powerlaw(), kw=kw)
    assert ptp.dia is None


def test_diag_offsets_device_and_host_forms():
    from speck_tpu_torch.ops.spgemm import _diag_offsets

    h = gen.make_stencil27(6)
    A = pt.device_put_csr(h, device="cpu")
    want = np.array(sorted(dz * 36 + dy * 6 + dx for dz in (-1, 0, 1)
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)))
    span = 2 * 43 + 1
    _eq(_diag_offsets(A, h, -43, span), want)
    _eq(_diag_offsets(None, h, -43, span), want)


@pytest.mark.parametrize("route", ["dia", "sdia"])
def test_float64_whole_matrix_routes(route, x64):
    rs = np.random.RandomState(10)
    if route == "dia":
        a = _band(200, range(-2, 3), rs)
        kw = {}
    else:
        a = _diag_mat(256, 256, [-16, -1, 0, 1, 16], rs)
        kw = dict(host_analysis_max_nnz=16)
    pj, ptp = _run_both(a, kw=kw, dtype=np.float64, new_values=True)
    assert ptp.dia is not None
    assert (ptp.dia.off_a is not None) == (route == "sdia")


def test_float64_still_raises_off_the_dia_routes(x64):
    """float64 off the whole-matrix DIA routes no longer raises: a band
    with outlier rows takes the same route as in JAX, and an unstructured
    input streams, both equal to JAX's within rtol 1e-12."""
    rs = np.random.RandomState(9)
    pj, ptp = _run_both(_mixed(n=512, seed=9), dtype=np.float64)
    assert ptp.dia is None
    r = sp.random(100, 100, 0.05, format="csr", random_state=rs)
    pj, ptp = _run_both(r, kw=dict(enable_dense=False), dtype=np.float64)
    assert ptp.dia is None and ptp.dia_rows is None
    assert ptp.stream.layout.n_stream_rows > 0


# ---------------------------------------------------------------------------
# The per-row DIA split
# ---------------------------------------------------------------------------


def _rect_band(rs):
    """A banded 2048 x 2000 B for the split's rectangular cases."""
    return _diag_mat(2048, 2000, range(-2, 3), rs)


def test_dia_rows_mixed_routing():
    """The outliers break the whole-matrix gate: the banded bulk rides the
    split's planes, the rest the stream; then plan reuse with new values
    (the planes convolved again from the stored masked slots)."""
    pj, ptp = _run_both(_mixed(), new_values=True)
    assert ptp.dia is None and ptp.dia_rows is not None
    assert ptp.dia_rows.span_a <= 9
    assert ptp.stream.layout.n_stream_rows > 0


@pytest.mark.parametrize("case", ["mixed", "rectangular", "random"])
def test_dia_rows_mask_and_pack(case):
    """plan_device_stream with the split on: the dia_mask and pack entries
    4 * N_QCLASS + 12 ... + 17 (the robust band, n_dia, n_live) equal,
    and the whole pack with them."""
    rs = np.random.RandomState(13)
    if case == "mixed":
        a = b = _mixed()
    elif case == "rectangular":
        a, b = _mixed(), _rect_band(rs)
    else:
        a = b = _powerlaw()
    ah, bh = st.HostCSR.from_scipy(a), st.HostCSR.from_scipy(b)
    row_ops = st.ops.analysis.host_analyze(ah, bh).row_ops.astype(np.int32)
    a32 = np.asarray(ah.data, np.float32).view(np.int32)
    Aj, At = _put(ah, np.float32)
    Bj, Bt = _put(bh, np.float32)
    dkw = dict(dia_span_cap=512, dia_waste_cap=8.0, dia_mem_budget=1 << 32,
               dia_itemsize=4)
    outj = jstream.plan_device_stream(
        Aj.indptr, Aj.indices, jnp.asarray(a32), Bj.indptr, Bj.indices,
        jnp.asarray(row_ops), None, None, min_q=8, direct_ok=True,
        use_dense=False, tile_rows=256, kw_max=512, cw_max=512, la_max=64,
        lb_max=64, max_tiles=0, m=ah.rows, w0=8192, w_cap=65536,
        use_dia_rows=True, **dkw)
    outt = tstream.plan_device_stream(
        At.indptr, At.indices, torch.from_numpy(a32), Bt.indptr, Bt.indices,
        torch.from_numpy(row_ops), None, None, min_q=8, direct_ok=True,
        m=ah.rows, w0=8192, w_cap=65536, use_dia_rows=True, **dkw)
    n_q = tstream.N_QCLASS
    _eq(outt[6][4 * n_q + 12: 4 * n_q + 18],
        np.asarray(outj[14])[4 * n_q + 12: 4 * n_q + 18])
    _eq(outt[6], outj[14])
    _eq(outt[7], outj[13])
    n_dia = int(outt[6][4 * n_q + 16])
    assert (n_dia > 0) == (case != "random")
    for i, name in enumerate(["rows_sorted", "e", "q_sorted", "el",
                              "ops_sorted"]):
        _eq(outt[i], outj[i], name)


@pytest.mark.parametrize("kind", ["disabled", "rectangular", "random"])
def test_dia_rows_parity(kind):
    if kind == "disabled":
        pj, ptp = _run_both(_mixed(),
                            kw=dict(dia_rows=False, enable_dense=False))
        assert ptp.dia_rows is None
    elif kind == "rectangular":
        pj, ptp = _run_both(_mixed(), _rect_band(np.random.RandomState(13)))
        assert ptp.dia_rows is not None
    else:
        pj, ptp = _run_both(_powerlaw())
        assert ptp.dia_rows is None


def test_default_routing_skips_the_dia_family():
    """The small power-law input takes neither DIA route in either package
    (it streams). The giant row at a quarter of the bench's rows fails
    both packages' DIA gates alike; the port then plans dense tiles, as
    JAX does there. The split's host gate rejects bench
    configs 2 and 3 whole, and the giant row."""
    jsp = importlib.import_module("speck_tpu.ops.spgemm")
    tsp = importlib.import_module("speck_tpu_torch.ops.spgemm")
    pj, ptp = _run_both(_powerlaw())
    assert ptp.stream is not None and ptp.stream.layout.n_stream_rows
    giant = gen.make_giant_row(mg=4000, NH=200, HN=400)
    gj = st.HostCSR(rows=giant.rows, cols=giant.cols,
                    row_offsets=giant.row_offsets, col_ids=giant.col_ids,
                    data=giant.data)
    Aj, At = st.device_put_csr(gj), pt.device_put_csr(giant, device="cpu")
    hj = st.ops.analysis.host_analyze(gj, gj)
    ht = tsp.host_analyze(giant, giant, tsp.HostEnds())
    # the port's host gates read the row ends of the call they serve
    for mod, A, h, hg, cfg, ends in [
            (jsp, Aj, gj, hj, st.SpgemmConfig(), ()),
            (tsp, At, giant, ht, pt.SpgemmConfig(), (tsp.HostEnds(),))]:
        assert mod._dia_spans(cfg, A, A, hg.a_dmin, hg.a_dmax, hg.b_dmin,
                              hg.b_dmax, hg.sp_sat) is None
        assert mod._sdia_gate(cfg, A, A, h, h, hg) is None
        assert not mod._host_dia_rows_plausible(h, h, cfg, *ends)
    assert pt.plan_spgemm(At, At).dense is not None
    cfg = pt.SpgemmConfig()
    for h in (gen.make_powerlaw(131072, seed=5),
              gen.make_powerlaw(262144, seed=7)):
        assert not tsp._host_dia_rows_plausible(h, h, cfg, tsp.HostEnds())


@pytest.mark.parametrize("which", ["stencil27", "mixed"])
def test_generators_are_the_bench_construction(which):
    import bench

    if which == "stencil27":
        got, want = gen.make_stencil27(7, seed=19), bench.make_stencil27(7)
    else:
        got = gen.make_mixed(3000, 5, 40, 9, seed=13)
        want = bench.make_mixed(3000, 5, 40, 9, seed=13)
    assert (got.rows, got.cols) == (want.rows, want.cols)
    _eq(np.asarray(got.row_offsets, np.int64),
        np.asarray(want.row_offsets, np.int64))
    _eq(np.asarray(got.col_ids, np.int64), np.asarray(want.col_ids, np.int64))
    _eq(got.data, want.data)
