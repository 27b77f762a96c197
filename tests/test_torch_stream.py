"""The port's analysis, planning and chunk stages against the JAX package.

Both packages get the same matrices (made from a seed with numpy, carried
across with HostCSR.from_host) and the same configuration. Held equal
element by element: the AnalysisResult fields, the planning pack, the
StreamLayout fields and the planning arrays (rows_sorted, e, el, and the
chunk records' p0, su, sa, src, pend, sid_bases); per chunk, nnz_row and
the staged (rid, col, counts), and the expand's (rid, col, val) bit for
bit (float32 through the packed record, float64 and bfloat16 through the
unpacked operands).
Staged values at rtol 1e-5 (the chunk sort may order duplicate products
differently, which changes only the fp32 summation order)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu.ops import stream as jstream
from speck_tpu.ops.analysis import analyze as j_analyze
from speck_tpu.ops.esc import pack_csr_arrays as j_pack
from speck_tpu_torch.ops import stream as tstream
from speck_tpu_torch.ops.analysis import analyze as t_analyze
from speck_tpu_torch.ops.esc import pack_csr_arrays as t_pack

_BASE = dict(enable_dense=False, enable_dia=False, enable_sdia=False,
             dia_rows=False)
CASES = {
    # power-law rows over several chunks
    "powerlaw": dict(stream_width=256, product_budget=1 << 13),
    # wide rows: a dense row over many W=64 rectangle rows
    "wide": dict(stream_width=64, product_budget=1 << 10),
}


def _powerlaw(m=1500, avg=6, alpha=2.2, seed=11):
    rs = np.random.RandomState(seed)
    lens = np.minimum((rs.pareto(alpha, m) + 1) * avg * 0.5, m // 4
                      ).astype(np.int64)
    rows = np.repeat(np.arange(m), lens)
    mat = sp.csr_matrix((rs.standard_normal(rows.shape[0]),
                         (rows, rs.randint(0, m, rows.shape[0]))),
                        shape=(m, m))
    mat.sum_duplicates()
    return st.HostCSR.from_scipy(mat)


def _wide(n=160, seed=5):
    rs = np.random.RandomState(seed)
    lil = sp.random(n, n, 0.08, format="csr", random_state=rs).tolil()
    lil[0, :] = rs.standard_normal(n)
    mat = lil.tocsr()
    mat.data = rs.standard_normal(mat.nnz)
    return st.HostCSR.from_scipy(mat)


_MATS = {"powerlaw": _powerlaw, "wide": _wide}


def _pair(case):
    h = _MATS[case]()
    kw = dict(_BASE, **CASES[case])
    return (h, st.device_put_csr(h), st.SpgemmConfig(**kw),
            pt.device_put_csr(pt.HostCSR.from_host(h), device="cpu"),
            pt.SpgemmConfig(**kw))


def test_analysis_fields_equal():
    h = _powerlaw()
    Aj = st.device_put_csr(h)
    At = pt.device_put_csr(pt.HostCSR.from_host(h), device="cpu")
    rj = j_analyze(Aj, Aj)
    rt = t_analyze(At, At)
    for f in ("row_ops", "a_len", "work", "row_ops_f", "max_work",
              "sum_products"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)


@pytest.mark.parametrize("case", list(CASES))
def test_planning_pack_equal(case):
    h, Aj, cj, At, ct = _pair(case)
    row_ops = st.ops.analysis.host_analyze(h, h).row_ops.astype(np.int32)
    a32 = np.asarray(h.data, np.float32).view(np.int32)
    m = h.rows
    outj = jstream.plan_device_stream(
        Aj.indptr, Aj.indices, jnp.asarray(a32), Aj.indptr, Aj.indices,
        jnp.asarray(row_ops), None, None, min_q=8, direct_ok=True,
        use_dense=False, tile_rows=256, kw_max=512, cw_max=512, la_max=64,
        lb_max=64, max_tiles=0, m=m, w0=ct.stream_width, w_cap=65536)
    outt = tstream.plan_device_stream(
        At.indptr, At.indices, torch.from_numpy(a32), At.indptr, At.indices,
        torch.from_numpy(row_ops), None, None, min_q=8, direct_ok=True, m=m,
        w0=ct.stream_width, w_cap=65536)
    np.testing.assert_array_equal(outt[6].numpy(), np.asarray(outj[14]))
    for i, name in enumerate(["rows_sorted", "e", "q_sorted", "el",
                              "ops_sorted"]):
        np.testing.assert_array_equal(outt[i].numpy(), np.asarray(outj[i]),
                                      err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_plan_layout_and_arrays_equal(case):
    h, Aj, cj, At, ct = _pair(case)
    pj = st.plan_spgemm(Aj, Aj, cj)
    ptp = pt.plan_spgemm(At, At, ct)
    lj, lt = pj.stream.layout, ptp.stream.layout
    for f in ("G", "W", "n_chunks", "total_q", "n_wide", "r_wide", "g_last",
              "n_stream_rows", "n_direct_rows", "direct_classes"):
        assert getattr(lt, f) == getattr(lj, f), f
    np.testing.assert_array_equal(lt.wide_segs, lj.wide_segs)
    if case == "wide":
        assert lt.n_wide > 0
    for f in ("rows_sorted", "e", "el", "ops_sorted"):
        np.testing.assert_array_equal(
            getattr(ptp.stream, f).numpy(),
            np.asarray(getattr(pj.stream, f)), err_msg=f)
    for f in ("p0", "su", "sa", "src", "pend", "sid_bases"):
        np.testing.assert_array_equal(
            getattr(ptp.stream.rec, f).numpy(),
            np.asarray(getattr(pj.stream, f)), err_msg=f)
    assert ptp.stream.pack_bits == pj.stream.pack_bits
    assert ptp.nnz == pj.nnz
    np.testing.assert_array_equal(ptp.row_offsets.numpy(),
                                  np.asarray(pj.row_offsets))


@pytest.mark.parametrize("case", list(CASES))
def test_stream_chunks_equal(case):
    h, Aj, cj, At, ct = _pair(case)
    sj = st.plan_spgemm(Aj, Aj, cj).stream
    stt = pt.plan_spgemm(At, At, ct).stream
    lo = stt.layout
    m, n = h.rows, h.cols
    CP = lo.G * lo.W
    bj = j_pack(Aj.indices, Aj.data)
    rec = stt.rec._replace(b=t_pack(At.indices, At.data))
    for c in range(lo.n_chunks):
        Gc = lo.g_last if c == lo.n_chunks - 1 else lo.G
        nnz_j, stg_j = jstream.stream_chunk(
            sj.rows_sorted, sj.e, sj.rowend, sj.q_sorted, sj.el,
            sj.ops_sorted, sj.p0, sj.su, sj.sa, sj.pend, bj, Aj.indices,
            Aj.data, Aj.data, sj.src, jnp.zeros((m,), jnp.int32),
            jnp.int32(c * CP), sj.rid_bases[c], sj.sid_bases[c], G=Gc,
            W=lo.W, n_cols=n, pack_bits=sj.pack_bits, stage=True, f64=False)
        nnz_t, stg_t = tstream.stream_chunk(
            rec, c, stt.rows_sorted, stt.q_sorted, stt.el, stt.ops_sorted,
            torch.zeros(m + 1, dtype=torch.int32), stage=True)
        np.testing.assert_array_equal(nnz_t[:m].numpy(), np.asarray(nnz_j))
        rid_j, col_j, val_j, cnt_j = (np.asarray(x) for x in stg_j)
        counts = stg_t[3].numpy()
        np.testing.assert_array_equal(counts, cnt_j)
        np.testing.assert_array_equal(stg_t[0].numpy(), rid_j)
        np.testing.assert_array_equal(stg_t[1].numpy(), col_j)
        live = np.arange(lo.W)[None, :] < counts[:, None]
        np.testing.assert_allclose(stg_t[2].numpy()[live], val_j[live],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case,value", [
    ("powerlaw", "float32"), ("wide", "float32"), ("powerlaw", "float64"),
    ("wide", "bfloat16")])
def test_expand_plain_equals_reference_expand(case, value):
    """Every chunk's expand: ``expand.expand_plain``, the K4 wrapper
    ``expand.stream_expand`` (which takes it on the CPU) and the chunk
    step's ``stream.chunk_expand`` over the plan's bound records, equal
    the JAX package's ``_expand_chunk`` in rid, col and val, bit for bit:
    float32 through the packed record, float64 (under ``jax_enable_x64``)
    and bfloat16 through the unpacked operands (the values rounded to
    bfloat16 once, on the host, for both)."""
    import jax

    from speck_tpu.ops.stream import _expand_chunk
    from speck_tpu_torch.ops.expand import expand_plain, stream_expand
    from speck_tpu_torch.ops.spgemm import _stream_operands

    j_expand = jax.jit(_expand_chunk, static_argnames=("G", "W", "n_cols",
                                                       "f64"))
    f64 = value != "float32"
    h = _MATS[case]()
    if value == "bfloat16":
        h = st.HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                       col_ids=h.col_ids, data=torch.from_numpy(h.data).to(
                           torch.bfloat16).double().numpy())
    kw = dict(_BASE, **CASES[case])
    x64 = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", value == "float64")
    try:
        Aj = st.device_put_csr(h, getattr(jnp, value))
        sj = st.plan_spgemm(Aj, Aj, st.SpgemmConfig(**kw)).stream
        At = pt.device_put_csr(pt.HostCSR.from_host(h),
                               getattr(torch, value), device="cpu")
        stt = pt.plan_spgemm(At, At, pt.SpgemmConfig(**kw)).stream
        lo = stt.layout
        n = h.cols
        CP = lo.G * lo.W
        bj = (jnp.zeros((1, 2), jnp.int32) if f64
              else j_pack(Aj.indices, Aj.data))
        rec = _stream_operands(At, At, stt.rec)
        ints = {2: np.int16, 4: np.int32, 8: np.int64}
        for c in range(lo.n_chunks):
            Gc = lo.g_last if c == lo.n_chunks - 1 else lo.G
            rid_j, col_j, val_j, _ = j_expand(
                sj.e, sj.rowend, sj.p0, sj.su, sj.sa, sj.pend, bj,
                Aj.indices, Aj.data, Aj.data, sj.src, jnp.int32(c * CP),
                sj.rid_bases[c], sj.sid_bases[c], G=Gc, W=lo.W, n_cols=n,
                f64=f64)
            val_j = np.asarray(val_j)
            args = (rec.e, rec.p0, rec.su, rec.sa, rec.pend, rec.b, c * CP,
                    rec.sid_bases[c], Gc, lo.W, n, CP)
            for rid, col, val in (expand_plain(*args), stream_expand(*args),
                                  tstream.chunk_expand(rec, c)):
                np.testing.assert_array_equal(rid.numpy(), np.asarray(rid_j))
                np.testing.assert_array_equal(col.numpy(), np.asarray(col_j))
                assert val.dtype == getattr(torch, value)
                assert val_j.dtype.itemsize == val.element_size()
                np.testing.assert_array_equal(
                    val.view(getattr(torch, ints[val.element_size()].__name__
                                     )).numpy(),
                    val_j.view(ints[val.element_size()]))
    finally:
        jax.config.update("jax_enable_x64", x64)


def test_tight_total_host_matches_port_layout(rng):
    """The numpy total twin equals the port's device layout total."""
    for trial in range(4):
        m = int(rng.integers(50, 400))
        W0 = 1 << int(rng.integers(5, 10))
        ops = rng.integers(0, 30, m)
        ops[rng.integers(0, m, 3)] = int(rng.integers(W0, W0 * 9))
        ops_t = torch.from_numpy(ops.astype(np.int32))
        out = tstream._plan_rows_impl(
            ops_t, ops_t > 0, torch.zeros(m, dtype=torch.bool), min_q=8,
            m=m, w_fixed=W0)
        assert int(out[6][1]) == tstream.tight_total_host(ops, W0, 8)
