"""The host route gates past ``host_analysis_max_nnz`` against the
reference's host gates.

The port's gates read each row's ends once (``analysis.HostEnds``,
O(rows)) and the product total only when a test reads it. The reference
package's numpy forms (``speck_tpu.ops.analysis.host_band_extremes``,
``host_gate_lite``, ``host_analyze`` and ``speck_tpu.ops.spgemm``'s
``_host_dia_rows_plausible`` and ``_host_dense_plausible``) read every
column id. On each input the port's band extremes, product total, host
analysis, per-row DIA band test and dense-tile test must give what the
reference's give, at the thresholds where the reference's answer turns;
and a plan made with the reference's gates patched into ``plan_spgemm``
must equal the port's own, field for field, and pass through the same
route.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu.ops import analysis as jan
from speck_tpu_torch.formats.csr import HostCSR
from speck_tpu_torch.ops import analysis as an
from speck_tpu_torch.probes.conformance import plan_fields, plan_routes
from speck_tpu_torch.utils import generators as gen
from speck_tpu_torch.utils import timings as tt

sg = importlib.import_module("speck_tpu_torch.ops.spgemm")
jsg = importlib.import_module("speck_tpu.ops.spgemm")


def _ref(h):
    return st.HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                      col_ids=h.col_ids, data=h.data)


def _ref_pair(ah, bh):
    """The reference's HostCSR of A's and B's host copies; B's is A's
    where B is A (``bh`` may be None)."""
    ja = _ref(ah)
    return ja, (ja if bh is ah else None if bh is None else _ref(bh))


# ---- the inputs -----------------------------------------------------------

def _csr(rows, cols, r, c, dtype=np.int32):
    mat = sp.csr_matrix((np.ones(len(r)), (r, c)), shape=(rows, cols))
    mat.sum_duplicates()
    mat.sort_indices()
    return HostCSR(rows=rows, cols=cols,
                   row_offsets=mat.indptr.astype(np.int64),
                   col_ids=mat.indices.astype(dtype), data=mat.data)


def _random(rows, cols, nnz, seed, skip=()):
    rs = np.random.RandomState(seed)
    r = rs.randint(0, rows, nnz)
    keep = ~np.isin(r, list(skip))
    return _csr(rows, cols, r[keep], rs.randint(0, cols, nnz)[keep])


def _empty_rows():
    """Leading, trailing and inner empty rows around a band."""
    n = 300
    r = np.repeat(np.arange(n), 5)
    c = np.clip(r + np.tile(np.arange(-2, 3), n), 0, n - 1)
    keep = (r >= 7) & (r < n - 11) & ((r < 100) | (r > 140)) & (r % 17 != 3)
    return _csr(n, n, r[keep], c[keep])


def _one_a_row():
    rs = np.random.RandomState(4)
    n = 500
    return _csr(n, n, np.arange(n), rs.randint(0, n, n))


def _int64_ids(h):
    return HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                   col_ids=np.asarray(h.col_ids, np.int64), data=h.data)


def _copy(h):
    return HostCSR(rows=h.rows, cols=h.cols,
                   row_offsets=np.array(h.row_offsets),
                   col_ids=np.array(h.col_ids), data=np.array(h.data))


def _pair(case):
    """(A's host copy, B's host copy) of a case; B is A where A·A."""
    if case == "stencil27":
        h = gen.make_stencil27(7)
        return h, h
    if case == "stencil27_int64_ids":
        h = _int64_ids(gen.make_stencil27(6))
        return h, h
    if case == "powerlaw":
        h = gen.make_powerlaw(2048, seed=5)
        return h, h
    if case == "giant_row":
        h = gen.make_giant_row(mg=4000, NH=200, HN=400)
        return h, h
    if case == "banded":
        h = gen.make_banded(1024, 6, seed=3)
        return h, h
    if case == "empty_rows":
        h = _empty_rows()
        return h, h
    if case == "mostly_empty_rows":
        h = _random(400, 400, 150, 9)
        return h, h
    if case == "one_a_row":
        h = _one_a_row()
        return h, h
    if case == "a_ne_b_square":
        return gen.make_banded(600, 4, seed=2), _random(600, 600, 3000, 8)
    if case == "a_ne_b_rectangular":
        return (_random(200, 350, 1500, 1, skip=(0, 199)),
                _random(350, 90, 900, 2, skip=(5, 6, 349)))
    if case == "b_a_copy":
        h = gen.make_banded(512, 3, seed=6)
        return h, _copy(h)
    if case == "empty_a":
        return _csr(40, 50, [], []), _random(50, 30, 100, 3)
    if case == "empty_b":
        return _random(40, 50, 100, 3), _csr(50, 30, [], [])
    raise KeyError(case)


CASES = ["stencil27", "stencil27_int64_ids", "powerlaw", "giant_row",
         "banded", "empty_rows", "mostly_empty_rows", "one_a_row",
         "a_ne_b_square", "a_ne_b_rectangular", "b_a_copy", "empty_a",
         "empty_b"]


def _turn(pred, hi=1 << 24):
    """The least t in [0, hi] where the monotone ``pred`` holds, or hi."""
    if not pred(hi):
        return hi
    lo = -1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if pred(mid) else (mid, hi)
    return hi


def _ref_dia_rows(ja, jb, cap):
    return jsg._host_dia_rows_plausible(
        ja, jb, st.SpgemmConfig(dia_span_cap=cap))


@pytest.mark.parametrize("case", CASES)
def test_gates_equal_the_reference(case):
    ah, bh = _pair(case)
    ja, jb = _ref_pair(ah, bh)
    ends = an.HostEnds()
    ext = an.host_band_extremes(ah, bh, ends)
    assert ext == jan.host_band_extremes(ja, jb)
    lite = an.host_gate_lite(ah, bh, ext)
    want = jan.host_gate_lite(ja, jb, ext)
    assert (lite.a_dmin, lite.a_dmax, lite.b_dmin, lite.b_dmax) == ext
    assert lite.total is None
    assert lite.sum_products == want.sum_products
    assert lite.sp_sat == want.sp_sat
    if ah.cols == bh.rows:
        hg = an.host_analyze(ah, bh, an.HostEnds())
        hj = jan.host_analyze(ja, jb)
        for f in ("a_dmin", "a_dmax", "b_dmin", "b_dmax", "sum_products",
                  "max_row_products"):
            assert getattr(hg, f) == getattr(hj, f), f
        np.testing.assert_array_equal(hg.row_ops, hj.row_ops)
        np.testing.assert_array_equal(hg.a_len, hj.a_len)
    # the per-row DIA band test, on either side of the cap where it turns
    t = _turn(lambda cap: _ref_dia_rows(ja, jb, cap))
    for cap in {max(t - 1, 0), t, t + 1}:
        assert sg._host_dia_rows_plausible(
            ah, bh, pt.SpgemmConfig(dia_span_cap=cap), ends) \
            == _ref_dia_rows(ja, jb, cap)
    # the dense-tile test, A's window alone and with B's output window
    for tile_rows in (1, 3, 256):
        kt = _turn(lambda kw: jsg._host_dense_plausible(ja, tile_rows, kw))
        for kw in {max(kt - 1, 0), kt}:
            assert sg._host_dense_plausible(ah, tile_rows, kw, ends) \
                == jsg._host_dense_plausible(ja, tile_rows, kw)
        if ah.cols != bh.rows:
            continue
        ct = _turn(lambda cw: jsg._host_dense_plausible(
            ja, tile_rows, 1 << 24, bh=jb, cw_max=cw))
        for kw, cw in ((1 << 24, max(ct - 1, 0)), (1 << 24, ct), (kt, ct),
                       (kt, 1 << 24), (max(kt - 1, 0), 1 << 24)):
            assert sg._host_dense_plausible(ah, tile_rows, kw, ends, bh=bh,
                                            cw_max=cw) \
                == jsg._host_dense_plausible(ja, tile_rows, kw, bh=jb,
                                             cw_max=cw)


def _ref_dense(ah, tile_rows, kw_max, ends, bh=None, cw_max=0):
    ja, jb = _ref_pair(ah, bh)
    return jsg._host_dense_plausible(ja, tile_rows, kw_max, bh=jb,
                                     cw_max=cw_max)


def _ref_plan(monkeypatch, A, B, cfg):
    """plan_spgemm with the reference's host gates in place of the
    port's O(rows) forms."""
    with monkeypatch.context() as mp:
        mp.setattr(sg, "host_band_extremes",
                   lambda ah, bh, ends: jan.host_band_extremes(
                       *_ref_pair(ah, bh)))
        mp.setattr(sg, "host_gate_lite",
                   lambda ah, bh, ext: jan.host_gate_lite(
                       *_ref_pair(ah, bh), ext))
        mp.setattr(sg, "_host_dia_rows_plausible",
                   lambda ah, bh, cfg, ends: _ref_dia_rows(
                       *_ref_pair(ah, bh), cfg.dia_span_cap))
        mp.setattr(sg, "_host_dense_plausible", _ref_dense)
        return pt.plan_spgemm(A, B, cfg)


PLAN_CASES = ["stencil27", "powerlaw", "giant_row", "banded", "empty_rows",
              "mostly_empty_rows", "one_a_row", "a_ne_b_square",
              "a_ne_b_rectangular", "b_a_copy"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plans_equal_the_reference_gates_plans(case, monkeypatch):
    """Past host_analysis_max_nnz (the lite gate and the host gates) and
    below it (host_analyze and the host gates), with the per-row DIA
    split and the dense tiles allowed."""
    ah, bh = _pair(case)
    A = pt.device_put_csr(ah, torch.float32, device="cpu")
    B = A if bh is ah else pt.device_put_csr(bh, torch.float32, device="cpu")
    for cfg in (pt.SpgemmConfig(host_analysis_max_nnz=16),
                pt.SpgemmConfig(host_analysis_max_nnz=16, dia_rows=True,
                                dense_cw=64, dense_kw=64),
                pt.SpgemmConfig()):
        want = _ref_plan(monkeypatch, A, B, cfg)
        got = pt.plan_spgemm(A, B, cfg)
        assert plan_fields(got) == plan_fields(want)
        assert plan_routes(got) == plan_routes(want)
        assert float(got.sum_products) == float(want.sum_products)


def test_product_total_only_where_a_check_reads_it(monkeypatch):
    """A stencil past host_analysis_max_nnz: with a plane budget that the
    sparse-DIA gate refuses, no O(nnz) host pass at all and the reference
    gates' stream plan; with one that admits the planes, the total once
    and the sparse-DIA plan, whose product equals the device-gated
    call's."""
    h = gen.make_stencil27(8)
    A = pt.device_put_csr(h, torch.float64, device="cpu")
    tight = pt.SpgemmConfig(host_analysis_max_nnz=16, dia_mem_budget=4096)
    tt.HOST_NNZ_PASSES.clear()
    got = pt.plan_spgemm(A, A, tight)
    assert tt.HOST_NNZ_PASSES == {}
    assert got.dia is None and got.stream is not None
    want = _ref_plan(monkeypatch, A, A, tight)
    assert plan_fields(got) == plan_fields(want)
    assert float(got.sum_products) == float(want.sum_products)

    roomy = pt.SpgemmConfig(host_analysis_max_nnz=16)
    tt.HOST_NNZ_PASSES.clear()
    plan = pt.plan_spgemm(A, A, roomy)
    assert tt.HOST_NNZ_PASSES == {"product_total": 1}
    assert plan_routes(plan) == {"sdia"}
    ja = _ref(h)
    assert plan.sum_products == jan.host_gate_lite(
        ja, ja, jan.host_band_extremes(ja, ja)).sum_products
    assert plan_fields(plan) == plan_fields(
        _ref_plan(monkeypatch, A, A, roomy))
    C = plan.execute()
    D = pt.spgemm(A, A, pt.SpgemmConfig(host_analysis=False))
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(C, f)[: C.nnz if f != "indptr" else None],
                           getattr(D, f)[: D.nnz if f != "indptr" else None])


def test_row_ends_once_a_call(monkeypatch):
    """One call past host_analysis_max_nnz that reaches both host gates
    builds each host copy's row ends once; B's are A's where B is A."""
    built = []
    real = an.row_ends
    monkeypatch.setattr(an, "row_ends", lambda h: built.append(h) or real(h))
    h = gen.make_stencil27(6)
    A = pt.device_put_csr(h, torch.float32, device="cpu")
    cfg = pt.SpgemmConfig(host_analysis_max_nnz=16, dia_mem_budget=4096,
                          dia_rows=True)
    tt.HOST_NNZ_PASSES.clear()
    pt.plan_spgemm(A, A, cfg)
    assert len(built) == 1 and built[0] is h
    assert tt.HOST_NNZ_PASSES == {}
