"""The general product stream of the port against speck_tpu on the CPU:
the dense-tile gate counted on the device, the unpacked two-key chunk
sort (``pack_bits == 0``), float64 values on the stream, the per-row DIA
split and ``esc_fixed``, and row blocking past ``ProductOverflow``.

The same seeded inputs, made with numpy, go through both packages:
``row_offsets`` and ``col_ids`` equal, values within rtol 1e-5 of JAX's
for float32 and 1e-12 for float64 (JAX under ``jax_enable_x64``, restored
after the test), and every result within rel_tol 2e-3 (float32) or 1e-9
(float64) of the scipy oracle. The planning arrays (``tile_stats``, the
pack, the staged planes) are integers and must be equal."""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu.ops import dense as jdense
from speck_tpu.ops import esc as jesc
from speck_tpu.ops import stream as jstream
from speck_tpu_torch import entry as tentry
from speck_tpu_torch.ops import dense as tdense
from speck_tpu_torch.ops import esc as tesc
from speck_tpu_torch.ops import stream as tstream
from speck_tpu_torch.utils import generators as gen

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
ORACLE_TOL = {np.float32: 2e-3, np.float64: 1e-9}
N_Q = tstream.N_QCLASS
INT_MAX = 2 ** 31 - 1


@pytest.fixture()
def x64():
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _random(n=3000, density=0.003, seed=5):
    rs = np.random.RandomState(seed)
    a = sp.random(n, n, density, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz)
    return a


def _powerlaw():
    return gen.make_powerlaw(1500, avg=6, seed=23).to_scipy()


def _banded():
    return gen.make_banded(1024, 4, seed=3).to_scipy()


def _put(h, dtype):
    return (st.device_put_csr(h, dtype),
            pt.device_put_csr(pt.HostCSR.from_host(h), dtype, device="cpu"))


def _assert_c(ah, bh, Cj, Ct, dtype):
    """C of both packages equal in structure, values within RTOL, and the
    port's within ORACLE_TOL of the scipy oracle."""
    _eq(np.asarray(Ct.row_offsets, np.int64),
        np.asarray(Cj.row_offsets, np.int64))
    _eq(np.asarray(Ct.col_ids, np.int64), np.asarray(Cj.col_ids, np.int64))
    assert Ct.data.dtype == np.dtype(dtype)
    np.testing.assert_allclose(Ct.data, Cj.data, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * 1e-1)
    r = pt.compare_csr(pt.oracle_spgemm(pt.HostCSR.from_host(ah),
                                        pt.HostCSR.from_host(bh)),
                       Ct, compare_data=True, rel_tol=ORACLE_TOL[dtype])
    assert r.ok, r.message


def _plan_both(a, b=None, kw=None, dtype=np.float32):
    ah = st.HostCSR.from_scipy(a)
    bh = ah if b is None else st.HostCSR.from_scipy(b)
    Aj, At = _put(ah, dtype)
    Bj, Bt = (Aj, At) if b is None else _put(bh, dtype)
    kw = kw or {}
    pj = st.plan_spgemm(Aj, Bj, st.SpgemmConfig(**kw))
    ptp = pt.plan_spgemm(At, Bt, pt.SpgemmConfig(**kw))
    return ah, bh, pj, ptp


def _stream_fields_equal(pj, ptp):
    lj, lt = pj.stream.layout, ptp.stream.layout
    for f in ("W", "G", "g_last", "n_chunks", "total_q", "n_wide", "r_wide",
              "n_stream_rows", "n_direct_rows"):
        assert getattr(lt, f) == getattr(lj, f), f
    assert ptp.stream.pack_bits == pj.stream.pack_bits
    assert ptp.stream.fused == pj.stream.fused
    assert ptp.nnz == pj.nnz


# ---------------------------------------------------------------------------
# The dense-tile gate: eligibility counted on the device
# ---------------------------------------------------------------------------


def _stats_args(h):
    ip = np.asarray(h.indptr, np.int32)
    ix = np.asarray(h.indices, np.int32)
    row_ops = st.ops.analysis.host_analyze(
        st.HostCSR.from_scipy(h), st.HostCSR.from_scipy(h)
    ).row_ops.astype(np.int32)
    a_len = np.diff(ip).astype(np.int32)
    return ip, ix, row_ops, a_len


def _holes():
    """The band with every seventh row and the last 300 rows empty (rows
    repeat their offsets; the last 256-row tile holds no nonzero)."""
    a = _banded().tolil()
    for r in list(range(0, 1024, 7)) + list(range(724, 1024)):
        a.rows[r], a.data[r] = [], []
    return a.tocsr()


@pytest.mark.parametrize("which", ["banded", "powerlaw", "holes"])
def test_tile_stats_equal_to_jax(which):
    """The (6, T) planes exactly, on an input whose tiles are all eligible
    (a band), on one with none (power law), and on the band with empty
    rows and empty tiles."""
    h = {"banded": _banded, "powerlaw": _powerlaw, "holes": _holes}[which]()
    ip, ix, row_ops, a_len = _stats_args(h)
    m = h.shape[0]
    sj = jdense.tile_stats(*(jnp.asarray(x) for x in (ip, ix, ip, ix,
                                                       row_ops, a_len)),
                           tile_rows=256, m=m)
    stt = tdense.tile_stats(*(torch.from_numpy(x) for x in (ip, ix, ip, ix,
                                                            row_ops, a_len)),
                            tile_rows=256, m=m)
    _eq(stt, sj)
    kspan, cspan = stt[1].numpy(), stt[3].numpy()
    elig = (kspan <= 512) & (cspan <= 512) & (cspan > 0)
    if which == "holes":
        assert (cspan == 0).sum() == 1 and elig.sum() == 3
    else:
        assert elig.all() if which == "banded" else not elig.any()


def _plan_stream_both(h, use_dense=True):
    """Both packages' plan_device_stream with the dense gate on at the
    default windows."""
    ip, ix, row_ops, a_len = _stats_args(h)
    a32 = np.asarray(h.data, np.float32).view(np.int32)
    m = h.shape[0]
    dkw = dict(tile_rows=256, kw_max=512, cw_max=512, la_max=64, lb_max=64,
               max_tiles=2048)
    outj = jstream.plan_device_stream(
        *(jnp.asarray(x) for x in (ip, ix, a32, ip, ix, row_ops)), None,
        None, min_q=8, direct_ok=True, use_dense=use_dense, m=m, **dkw)
    outt = tstream.plan_device_stream(
        *(torch.from_numpy(x) for x in (ip, ix, a32, ip, ix, row_ops)), None,
        None, min_q=8, direct_ok=True, use_dense=use_dense, m=m, **dkw)
    return outj, outt


@pytest.mark.parametrize("which", ["banded", "powerlaw", "random"])
def test_dense_eligibility_pack_equal_to_jax(which):
    """plan_device_stream with the dense gate on: the whole pack (n_elig,
    the effective windows), the sorted tile arrays and the stream's row
    order equal; a band's tiles are all eligible, a power law's and the
    3000 x 3000 random input's none."""
    outj, outt = _plan_stream_both({"banded": _banded, "powerlaw": _powerlaw,
                                    "random": _random}[which]())
    _eq(outt[6], outj[14], "pack")
    for i, name in [(8, "r0"), (9, "kb_s"), (10, "cb_s"), (11, "valid")]:
        _eq(outt[i], outj[i + 1], name)
    for i, name in enumerate(["rows_sorted", "e", "q_sorted", "el",
                              "ops_sorted"]):
        _eq(outt[i], outj[i], name)
    _eq(outt[5], outj[8], "nnz_init")
    n_elig = int(outt[6][4 * N_Q])
    assert (n_elig > 0) == (which == "banded")


@pytest.mark.parametrize("which", ["random", "powerlaw"])
def test_host_analysis_off_streams_like_jax(which):
    """Under host_analysis=False no host pre-reject runs: the tiles are
    counted in the planning pass, none qualifies, and both packages
    stream with equal plan fields and output."""
    a = _random() if which == "random" else _powerlaw()
    kw = dict(host_analysis=False)
    ah, bh, pj, ptp = _plan_both(a, kw=kw)
    assert pj.dense is None and pj.dia is None
    assert ptp.dia is None and ptp.stream is not None
    _stream_fields_equal(pj, ptp)
    _eq(ptp.row_offsets, pj.row_offsets)
    _assert_c(ah, bh, st.device_get_csr(pj.execute()),
              pt.device_get_csr(ptp.execute()), np.float32)


def test_dense_tiles_raise_only_where_jax_takes_them():
    """A narrow band with the DIA routes off and no host analysis: JAX
    counts eligible tiles and plans its dense group; the port counts the
    same tiles in its planning pass and takes them too (the dense-tile
    route no longer raises): equal tile arrays and windows, equal C."""
    kw = dict(host_analysis=False, enable_dia=False, enable_sdia=False,
              dia_rows=False)
    ah = st.HostCSR.from_scipy(_banded())
    Aj, At = _put(ah, np.float32)
    pj = st.plan_spgemm(Aj, Aj, st.SpgemmConfig(**kw))
    ptp = pt.plan_spgemm(At, At, pt.SpgemmConfig(**kw))
    assert pj.dense is not None and ptp.dense is not None
    for f in ("r0s", "kbases", "cbases", "valids"):
        _eq(getattr(ptp.dense, f), getattr(pj.dense, f), f)
    for f in ("boffs", "kw", "cw", "la", "lb", "full_cover"):
        assert getattr(ptp.dense, f) == getattr(pj.dense, f), f
    _assert_c(ah, ah, st.device_get_csr(pj.execute()),
              pt.device_get_csr(ptp.execute()), np.float32)


def test_giant_row_tiles_eligible_in_both():
    """The quarter giant row: the reference's planning pass counts
    eligible tiles (it runs them dense); the port's pack is equal, so it
    raises for the dense-tile route there and nowhere else."""
    h = gen.make_giant_row(mg=4000, NH=200, HN=400).to_scipy()
    outj, outt = _plan_stream_both(h)
    _eq(outt[6][4 * N_Q: 4 * N_Q + 5], np.asarray(outj[14])[
        4 * N_Q: 4 * N_Q + 5])
    assert int(outt[6][4 * N_Q]) > 0


# ---------------------------------------------------------------------------
# pack_bits == 0: the unpacked two-key chunk sort
# ---------------------------------------------------------------------------


def _wide_cols(seed=41):
    """A (150, 400) times a (400, 2^20 + 5) B of 20 nonzeros a row: 2^20
    columns."""
    rs = np.random.RandomState(seed)
    a = sp.random(150, 400, 0.05, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz)
    n = (1 << 20) + 5
    rows = np.repeat(np.arange(400), 20)
    b = sp.csr_matrix((rs.standard_normal(rows.size),
                       (rows, rs.randint(0, n, rows.size))), shape=(400, n))
    b.sum_duplicates()
    return a, b


def test_unpacked_two_key_sort_matches_jax():
    """2^20 columns at W = 8192: the packed key would overflow int32, so
    both packages sort on two keys; the staged rid and col planes and the
    counts are equal, the values within rtol."""
    a, b = _wide_cols()
    kw = dict(enable_dense=False, product_budget=1 << 14)
    ah, bh, pj, ptp = _plan_both(a, b, kw=kw)
    assert pj.stream.pack_bits == 0 and ptp.stream.pack_bits == 0
    _stream_fields_equal(pj, ptp)
    assert ptp.stream.staged is not None
    for sj, stt in zip(pj.stream.staged, ptp.stream.staged):
        _eq(stt[0], sj[0], "rid")
        _eq(stt[1], sj[1], "col")
        _eq(stt[3], sj[3], "counts")
        np.testing.assert_allclose(stt[2].numpy(), np.asarray(sj[2]),
                                   rtol=1e-5, atol=1e-6)
    _assert_c(ah, bh, st.device_get_csr(pj.execute()),
              pt.device_get_csr(ptp.execute()), np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sort_rect_two_keys_is_a_stable_lexsort(dtype):
    """_sort_rect with pack_bits == 0 on a chunk with dead slots: the
    order of a stable (rid, col) lexsort with dead slots last, dead rids
    INT_MAX and dead columns n_cols."""
    rs = np.random.RandomState(3)
    G, W, n_cols = 6, 64, 1 << 21
    rid = np.sort(rs.randint(0, 20, (G, W)), axis=1) + 100 * np.arange(
        G)[:, None]
    col = rs.randint(0, 40, (G, W))
    dead = rs.rand(G, W) < 0.2
    col = np.where(dead, n_cols, col)
    val = rs.standard_normal((G, W))
    rid_s, col_s, val_s = tstream._sort_rect(
        torch.from_numpy(rid.astype(np.int32)),
        torch.from_numpy(col.astype(np.int32)),
        torch.from_numpy(val).to(dtype), n_cols, 0)
    key_r = np.where(dead, INT_MAX, rid)
    for g in range(G):
        order = np.lexsort((col[g], key_r[g]))   # stable, last key first
        _eq(rid_s[g], key_r[g][order])
        _eq(col_s[g], col[g][order])
        _eq(val_s[g], torch.from_numpy(val[g][order]).to(dtype))
    assert val_s.dtype == dtype


# ---------------------------------------------------------------------------
# float64 values
# ---------------------------------------------------------------------------


def _fp64_input(seed=9):
    """200 x 200 at density 0.05 plus one dense row: wide at W = 256."""
    rs = np.random.RandomState(seed)
    base = sp.random(200, 200, 0.05, format="csr", random_state=rs)
    base.data = rs.standard_normal(base.nnz)
    lil = base.tolil()
    lil[3, :] = rs.standard_normal(200)
    return lil.tocsr()


_FP64 = dict(product_budget=1 << 14, enable_dense=False, stream_width=256)


def _scaled(h):
    return st.HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                      col_ids=h.col_ids, data=h.data * -1.5 + 0.125)


@pytest.mark.parametrize("case", ["fused", "two_phase", "new_values"])
def test_float64_stream_matches_jax(case, x64):
    """The stream with a wide row in float64: fused staging, the two-phase
    numeric path, and plan reuse with new values."""
    kw = dict(_FP64)
    if case == "two_phase":
        kw["fused_staging_budget"] = 0
    ah, bh, pj, ptp = _plan_both(_fp64_input(), kw=kw, dtype=np.float64)
    _stream_fields_equal(pj, ptp)
    assert ptp.stream.layout.n_wide > 0
    assert ptp.stream.fused == (case != "two_phase")
    if case == "new_values":
        ah = bh = _scaled(ah)
        Aj, At = _put(ah, np.float64)
        Cj = st.device_get_csr(pj.execute(Aj, Aj))
        Ct = pt.device_get_csr(ptp.execute(At, At))
    else:
        Cj = st.device_get_csr(pj.execute())
        Ct = pt.device_get_csr(ptp.execute())
    _assert_c(ah, bh, Cj, Ct, np.float64)


def test_float64_dia_rows_split_with_stream_rows(x64):
    """The per-row DIA split beside stream rows (a band with outlier
    rows) in float64: the same split, C equal to JAX's."""
    a = gen.make_mixed(2048, 4, 24, 12, seed=3).to_scipy()
    ah, bh, pj, ptp = _plan_both(a, dtype=np.float64)
    assert pj.dia_rows is not None and ptp.dia_rows is not None
    assert ptp.stream.layout.n_stream_rows > 0
    for f in ("span_a", "span_b", "span_c", "dmin_a", "dmin_b"):
        assert getattr(ptp.dia_rows, f) == getattr(pj.dia_rows, f), f
    _stream_fields_equal(pj, ptp)
    _assert_c(ah, bh, st.device_get_csr(pj.execute()),
              pt.device_get_csr(ptp.execute()), np.float64)


def test_esc_fixed_float64_matches_jax(x64):
    a = pt.HostCSR.from_scipy(_powerlaw())
    cap = tentry.fixed_cap(a, a)
    args_t = tentry.esc_args(a, a, "cpu", np.float64)
    args_j = tuple(jnp.asarray(x.numpy()) for x in args_t)
    cj = jax.jit(partial(jesc.esc_fixed, cap=cap, n_cols=a.cols))(*args_j)
    ct = tesc.esc_fixed(*args_t, cap=cap, n_cols=a.cols)
    counts = np.asarray(cj[0])
    _eq(ct[0], counts)
    _eq(ct[1], cj[1])
    assert ct[2].dtype == torch.float64
    inside = np.arange(cap)[None, :] < counts[:, None]
    np.testing.assert_allclose(ct[2].numpy()[inside],
                               np.asarray(cj[2])[inside], rtol=1e-12,
                               atol=1e-13)
    from speck_tpu_torch.parallel import padded_to_host_csr

    got = padded_to_host_csr(*ct, a.rows, a.cols)
    r = pt.compare_csr(pt.oracle_spgemm(a, a), got, compare_data=True,
                       rel_tol=1e-9)
    assert r.ok, r.message


# ---------------------------------------------------------------------------
# Row blocking past ProductOverflow
# ---------------------------------------------------------------------------


def _blocking_input(seed=17):
    rs = np.random.RandomState(seed)
    a = sp.random(300, 300, 0.03, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz) + 0.5
    return a


def test_row_blocking_matches_jax(monkeypatch):
    """~19k products under block_products = 12000: plan_spgemm raises
    ProductOverflow in both packages, spgemm runs row blocks of at most
    6000 products, and C equals JAX's (its blocks concatenate to its
    single plan's C, which is compiled once here)."""
    tsp = importlib.import_module("speck_tpu_torch.ops.spgemm")
    a = _blocking_input()
    ah = st.HostCSR.from_scipy(a)
    Aj, At = _put(ah, np.float32)
    # small enough for dense tiles, which the port does not run yet
    base = dict(product_budget=1 << 14, enable_dense=False)
    kw = dict(base, block_products=12000)
    with pytest.raises(st.ProductOverflow):
        st.plan_spgemm(Aj, Aj, st.SpgemmConfig(**kw))
    with pytest.raises(pt.ProductOverflow):
        pt.plan_spgemm(At, At, pt.SpgemmConfig(**kw))
    blocks = []
    real = tsp.plan_spgemm

    def counting(A, B, cfg=None, timings=None):
        blocks.append(A.shape[0])
        return real(A, B, cfg, timings)

    monkeypatch.setattr(tsp, "plan_spgemm", counting)
    Ct = pt.device_get_csr(pt.spgemm(At, At, pt.SpgemmConfig(**kw)))
    assert len(blocks) >= 1 + 4 and sum(blocks[1:]) == 300
    Cj = st.device_get_csr(st.spgemm(Aj, Aj, st.SpgemmConfig(**base)))
    _assert_c(ah, ah, Cj, Ct, np.float32)


def test_row_blocking_single_wide_row_raises():
    rs = np.random.RandomState(4)
    a = sp.random(64, 64, 0.1, format="csr", random_state=rs)
    A = pt.device_put_csr(pt.HostCSR.from_scipy(a), device="cpu")
    with pytest.raises(pt.ProductOverflow, match="single row"):
        pt.spgemm(A, A, pt.SpgemmConfig(product_budget=1 << 14,
                                        block_products=16))
