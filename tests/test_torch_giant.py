"""The bench's giant row (one row of A @ A with 5 * 10^7 products, the
case of the reference's windowed global-map path) through the port on the
CPU, held to speck_tpu on the same input.

``make_giant_row`` copies ``bench.py``'s construction (which imports jax,
so the port keeps its own). At a small scale with a narrow stream the
giant row still takes stream chunks and a finish class; both packages
plan it, and the port must equal the reference: layout and finish fields
equal, row_offsets and col_ids equal, values within rtol 1e-5 of JAX and
within rel_tol 2e-3 of the scipy oracle (the JAX stream tests' own bar).
On the CPU the kernels' wrappers run their plain versions and count no
launch."""

import numpy as np
import pytest
import scipy.sparse as sp

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu_torch.ops import bitonic, contract
from speck_tpu_torch.utils.generators import make_giant_row

_BASE = dict(enable_dense=False, enable_dia=False, enable_sdia=False,
             dia_rows=False)
# a quarter of the bench's rows; row 0 has NH * HN = 80,000 products
SMALL = dict(mg=4000, NH=200, HN=400)
# chunks of (64, 256) and one finish class, as the bench's row takes
# (64, 65536) chunks and a (1, 2^23) finish at the default configuration
NARROW = dict(stream_width=256, product_budget=1 << 14)


def bench_giant(NH, HN=10000):
    """``bench.py``'s construction of the giant row, verbatim but for NH and
    HN (the bench's 5000 and 10000)."""
    mg = 40000
    rsg = np.random.RandomState(17)
    hrow = np.repeat(np.arange(10000, 10000 + NH), HN)
    hcol = ((np.tile(np.arange(HN), NH)
             + np.repeat(np.arange(NH) * 37, HN)) % 10000) + 25000
    lr = np.repeat(np.arange(1, 5000), 16)
    lc = rsg.randint(1, 5000, lr.shape[0])
    gm = sp.csr_matrix(
        (rsg.standard_normal(NH + hrow.shape[0] + lr.shape[0]),
         (np.concatenate([np.zeros(NH, int), hrow, lr]),
          np.concatenate([np.arange(10000, 10000 + NH), hcol, lc]))),
        shape=(mg, mg))
    gm.sum_duplicates()
    return gm


@pytest.mark.parametrize("NH,HN", [(40, 10000), (7, 300)])
def test_make_giant_row_is_the_bench_construction(NH, HN):
    h = make_giant_row(NH=NH, HN=HN)
    want = bench_giant(NH, HN)
    assert (h.rows, h.cols) == (40000, 40000)
    np.testing.assert_array_equal(np.asarray(h.row_offsets), want.indptr)
    np.testing.assert_array_equal(np.asarray(h.col_ids), want.indices)
    np.testing.assert_array_equal(np.asarray(h.data), want.data)


def test_make_giant_row_full_size_counts():
    """The defaults give the bench's matrix: 40,000 rows and 50,084,873
    nonzeros, 5 * 10^7 products in row 0. Checked at NH = 40 (building the
    full matrix takes seconds and gigabytes): row 0 and the heavy rows hold
    NH + NH * HN distinct entries, and the light rows' random entries are
    drawn before NH matters, so the full count follows."""
    NH, HN = 40, 10000
    h = make_giant_row(NH=NH)
    ro = np.asarray(h.row_offsets, np.int64)
    lens = np.diff(ro)
    assert lens[0] == NH and (lens[10000:10000 + NH] == HN).all()
    light = h.nnz - NH - NH * HN
    assert 5000 + 5000 * HN + light == 50084873
    assert int(lens[np.asarray(h.col_ids[:NH], np.int64)].sum()) == NH * HN


def _plan_both(h, kw):
    cj = st.SpgemmConfig(**dict(_BASE, **kw))
    ct = pt.SpgemmConfig(**dict(_BASE, **kw))
    hj = st.HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                    col_ids=h.col_ids, data=h.data)
    Aj = st.device_put_csr(hj)
    At = pt.device_put_csr(h, device="cpu")
    return st.plan_spgemm(Aj, Aj, cj), pt.plan_spgemm(At, At, ct)


def test_giant_row_plan_and_result_match_jax_and_oracle():
    h = make_giant_row(**SMALL)
    n1, n2 = contract.LAUNCHES, bitonic.LAUNCHES
    s1, s2 = dict(contract.LAUNCH_SHAPES), dict(bitonic.LAUNCH_SHAPES)
    pj, ptp = _plan_both(h, NARROW)
    lj, lt = pj.stream.layout, ptp.stream.layout
    for f in ("G", "W", "n_chunks", "total_q", "n_wide", "r_wide",
              "g_last", "n_stream_rows", "n_direct_rows"):
        assert getattr(lt, f) == getattr(lj, f), f
    np.testing.assert_array_equal(lt.wide_segs, lj.wide_segs)
    assert lt.n_chunks > 1 and lt.n_wide == 1
    assert ptp.nnz == pj.nnz
    Cj = st.device_get_csr(pj.execute())
    Ct = pt.device_get_csr(ptp.execute())
    fj, ft = pj.stream.finish, ptp.stream.finish
    assert ft["ladder_levels"] == fj["ladder_levels"] == 0
    assert len(ft["classes"]) == len(fj["classes"]) == 1
    for a, b in zip(ft["classes"], fj["classes"]):
        for f in ("R2", "W2", "E_pad"):
            assert a[f] == b[f], f
        for f in ("entry_excl", "row_total", "rid_of_out"):
            np.testing.assert_array_equal(a[f].numpy(), np.asarray(b[f]))
    np.testing.assert_array_equal(np.asarray(Ct.row_offsets, np.int64),
                                  np.asarray(Cj.row_offsets, np.int64))
    np.testing.assert_array_equal(np.asarray(Ct.col_ids, np.int64),
                                  np.asarray(Cj.col_ids, np.int64))
    np.testing.assert_allclose(Ct.data, Cj.data, rtol=1e-5, atol=1e-6)
    r = pt.compare_csr(pt.oracle_spgemm(h, h), Ct, compare_data=True,
                       rel_tol=2e-3)
    assert r.ok, r.message
    # the plain versions ran: no launch counted, by shape either
    assert (contract.LAUNCHES, bitonic.LAUNCHES) == (n1, n2)
    assert contract.LAUNCH_SHAPES == s1 and bitonic.LAUNCH_SHAPES == s2


def test_giant_row_contract_shapes(monkeypatch):
    """The contracts the small giant row runs, by (R, W, rid): the chunks'
    rid planes and one per-row finish of the row's pow2 entry width, the
    pattern the bench's row has at full size ((64, 65536) chunks, a
    (1, 2^23) finish)."""
    from speck_tpu_torch.ops import stream

    shapes = {}
    plain = stream.stream_contract

    def counted(rid, col, val, n_cols, live=None):
        key = (col.shape[0], col.shape[1],
               "row" if rid.stride(1) == 0 else "plane")
        shapes[key] = shapes.get(key, 0) + 1
        return plain(rid, col, val, n_cols, live)

    monkeypatch.setattr(stream, "stream_contract", counted)
    h = make_giant_row(**SMALL)
    A = pt.device_put_csr(h, device="cpu")
    pt.plan_spgemm(A, A, pt.SpgemmConfig(**dict(_BASE, **NARROW))).execute()
    assert shapes == {(64, 256, "plane"): 12, (48, 256, "plane"): 1,
                      (1, 131072, "row"): 1}
