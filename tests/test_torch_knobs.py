"""The reference's four A/B knobs in speck_tpu_torch, against speck_tpu:
``stream_sort_impl`` (every name sorts with K2 on the card and the plain
stable sort here), ``stream_compact_impl="scatter"``,
``stream_expand_impl="decode"`` (every name runs the one expand, K4 on
the card) and ``stream_level_factor`` 3 (merge levels at widths that are
not powers of two), on ``spgemm`` and on the mesh (four CPU shards).

Structure and plan fields (the ``LevelPlan``s included) equal to the
reference's; values within rtol 1e-5 of it (duplicates may sum in another
order) and rel_tol 2e-3 of the scipy oracle, the reference stream tests'
bar. The compaction and expand forms are permutations of the same
entries, so the port's forms equal its default bit for bit."""



import numpy as np
import pytest
import scipy.sparse as sp
import torch

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu_torch.ops import bitonic, stream

_BASE = dict(enable_dense=False, enable_dia=False, enable_sdia=False,
             dia_rows=False)


def _wide(seed=7, n=160):
    """Random 160x160 at density 0.08 plus two dense rows (wide at
    W = 64), made with numpy."""
    rs = np.random.RandomState(seed)
    lil = sp.random(n, n, 0.08, format="csr", random_state=rs).tolil()
    lil[0, :] = rs.standard_normal(n)
    lil[7, :] = rs.standard_normal(n)
    m = lil.tocsr()
    m.data = rs.standard_normal(m.nnz)
    return pt.HostCSR.from_scipy(m)


@pytest.fixture(scope="module")
def wide():
    return _wide()


def _both(h, kw):
    """(port plan, port C, reference plan, reference C) under ``kw``."""
    Aj = st.device_put_csr(st.HostCSR.from_scipy(h.to_scipy()))
    At = pt.device_put_csr(h, device="cpu")
    pj = st.plan_spgemm(Aj, Aj, st.SpgemmConfig(**kw))
    ptp = pt.plan_spgemm(At, At, pt.SpgemmConfig(**kw))
    return (ptp, pt.device_get_csr(ptp.execute()), pj,
            st.device_get_csr(pj.execute()))


def _same(h, Ct, Cj):
    np.testing.assert_array_equal(np.asarray(Ct.row_offsets, np.int64),
                                  np.asarray(Cj.row_offsets, np.int64))
    np.testing.assert_array_equal(np.asarray(Ct.col_ids, np.int64),
                                  np.asarray(Cj.col_ids, np.int64))
    np.testing.assert_allclose(Ct.data, Cj.data, rtol=1e-5, atol=1e-6)
    r = pt.compare_csr(pt.oracle_spgemm(h, h), Ct, compare_data=True,
                       rel_tol=2e-3)
    assert r.ok, r.message


def _port(h, kw):
    A = pt.device_put_csr(h, device="cpu")
    return pt.device_get_csr(pt.spgemm(A, A, pt.SpgemmConfig(**kw)))


def _bits_equal(C0, C1):
    np.testing.assert_array_equal(C0.row_offsets, C1.row_offsets)
    np.testing.assert_array_equal(C0.col_ids, C1.col_ids)
    np.testing.assert_array_equal(C0.data, C1.data)


@pytest.mark.parametrize("impl", list(stream.SORT_IMPLS))
def test_sort_impls_match_the_reference(wide, impl):
    """The port of test_stream.py's test_bitonic_sort_matches_xla and
    test_blocked_sort_matches_xla: each stream_sort_impl over wide rows
    (levels and finish). The port runs one stable sort for every name, so
    its results equal the default's bit for bit."""
    kw = dict(_BASE, stream_width=64, product_budget=1 << 10,
              stream_sort_impl=impl)
    Ct = _port(wide, kw)
    _bits_equal(Ct, _port(wide, dict(kw, stream_sort_impl="auto")))
    if impl in ("auto", "bitonic"):
        # the reference's lax.sort and its bitonic network (the other
        # names sort alike: its own tests hold them equal to lax.sort)
        _, Ct, _, Cj = _both(wide, kw)
        _same(wide, Ct, Cj)


def test_row_sort_matches_the_blocked_merge_sort(rng):
    """The unit half of test_blocked_sort_matches_xla: K2's plain version
    against the reference's blocked_sort_pairs, keys equal and (key,
    payload) pairs equal as multisets (the blocked form is not stable),
    with a width that is not a power of two beside it."""
    import jax.numpy as jnp
    from speck_tpu.ops.bitonic import blocked_sort_pairs

    key = rng.integers(0, 1 << 28, size=(3, 4096)).astype(np.int32)
    v2 = rng.integers(0, 99, size=(3, 4096)).astype(np.int32)
    k_j, (v2_j,) = blocked_sort_pairs(jnp.asarray(key), [jnp.asarray(v2)],
                                      block=512)
    k_t, (v2_t,) = bitonic.row_sort(torch.from_numpy(key),
                                    [torch.from_numpy(v2)])
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    for r in range(3):
        assert (sorted(zip(k_t[r].tolist(), v2_t[r].tolist()))
                == sorted(zip(np.asarray(k_j)[r].tolist(),
                              np.asarray(v2_j)[r].tolist())))
    k3, (p3,) = bitonic.row_sort(torch.from_numpy(key[:, :3000].copy()),
                                 [torch.from_numpy(v2[:, :3000].copy())])
    order = np.argsort(key[:, :3000], axis=1, kind="stable")
    np.testing.assert_array_equal(p3.numpy(),
                                  np.take_along_axis(v2[:, :3000], order, 1))


@pytest.mark.parametrize("case", ["fused", "wide_fused", "wide_two_phase"])
def test_scatter_compact_matches_sort(wide, case):
    """The port of test_stream.py's test_scatter_compact_matches_sort: the
    scatter compaction equals the rank sort element for element, on the
    fused, wide-row and two-phase paths, and the reference's scatter
    form."""
    kw = dict(_BASE, stream_width=64, product_budget=1 << 10)
    if case == "fused":
        kw.update(stream_max_width=1 << 30)
    else:
        kw.update(fused_staging_budget=(1 << 30 if case == "wide_fused"
                                        else 0))
    kws = dict(kw, stream_compact_impl="scatter")
    _, Ct, _, Cj = _both(wide, kws)
    _same(wide, Ct, Cj)
    _bits_equal(Ct, _port(wide, kw))


def test_scatter_compact_planes():
    """The scatter form's staged planes: the live prefix equal to the rank
    sort's, the rest (INT_MAX, INT_MAX, 0) as in the reference."""
    rs = np.random.RandomState(5)
    G, W = 3, 16
    col = np.sort(rs.randint(0, 6, (G, W)), 1).astype(np.int32)
    rid = np.zeros((G, W), np.int32)
    val = rs.standard_normal((G, W)).astype(np.float32)
    from speck_tpu_torch.ops.contract import contract_plain

    last, run_sum = contract_plain(
        torch.from_numpy(rid), torch.from_numpy(col),
        torch.from_numpy(val), 6)
    s = stream._compact_rect(last, torch.from_numpy(rid),
                             torch.from_numpy(col), run_sum, "sort")
    c = stream._compact_rect(last, torch.from_numpy(rid),
                             torch.from_numpy(col), run_sum, "scatter")
    assert torch.equal(s[3], c[3])
    for g in range(G):
        n = int(s[3][g])
        for k in range(3):
            assert torch.equal(s[k][g, :n], c[k][g, :n])
        assert bool((c[0][g, n:] == stream.INT_MAX).all())
        assert bool((c[1][g, n:] == stream.INT_MAX).all())
        assert bool((c[2][g, n:] == 0).all())


def test_dia_scatter_compact_matches_sort():
    """The port of test_dia.py's test_dia_scatter_compact_matches_sort:
    both settings stage the same planes, on the counting pass and on a
    numeric replay with new values."""
    rs = np.random.RandomState(11)
    n = 300
    a = sp.diags([rs.standard_normal(n - abs(o)) for o in range(-2, 3)],
                 list(range(-2, 3)), shape=(n, n), format="csr")
    A = pt.device_put_csr(pt.HostCSR.from_scipy(a), device="cpu")
    a2 = a.copy()
    a2.data = rs.standard_normal(a2.nnz)
    A2 = pt.device_put_csr(pt.HostCSR.from_scipy(a2), device="cpu")
    outs, replays = [], []
    for impl in ("sort", "scatter"):
        plan = pt.plan_spgemm(A, A, pt.SpgemmConfig(stream_compact_impl=impl))
        assert plan.dia is not None
        outs.append(pt.device_get_csr(plan.execute()))
        replays.append(pt.device_get_csr(plan.execute(A2, A2)))
    _bits_equal(*outs)
    _bits_equal(*replays)
    h2 = pt.HostCSR.from_scipy(a2)
    assert pt.compare_csr(pt.oracle_spgemm(h2, h2), replays[1],
                          compare_data=True, rel_tol=2e-3).ok


@pytest.mark.parametrize("kw", [dict(stream_width=64, product_budget=1 << 10),
                                dict(stream_width=64, product_budget=1 << 10,
                                     fused_staging_budget=0),
                                dict(stream_width=256, product_budget=1 << 13,
                                     enable_accum=True, accum_min_ops=200)])
def test_decode_expand_matches_the_reference(wide, kw):
    """stream_expand_impl="decode" (the reference's per-slot decode, the
    port's one expand) on the fused and two-phase stream and the
    accumulator: the reference's structure, and the fill form's entries
    bit for bit."""
    kw = dict(_BASE, stream_expand_impl="decode", **kw)
    pt_plan, Ct, pj, Cj = _both(wide, kw)
    _same(wide, Ct, Cj)
    if kw.get("enable_accum"):
        assert pt_plan.stream.n_accum > 0
    _bits_equal(Ct, _port(wide, dict(kw, stream_expand_impl="fill")))


@pytest.mark.parametrize("F", [3])
def test_level_factor_plans_match_the_reference(F):
    """A level factor that is not a power of two: merge levels at 3 * 64,
    9 * 64 ... slots (K2 padded on the card), the LevelPlans equal to
    the reference's, the output to its and the oracle's."""
    rs = np.random.RandomState(3)
    n = 1200
    lil = sp.random(n, n, 0.004, format="csr", random_state=rs).tolil()
    for r in (0, 5, 9):
        lil[r, rs.choice(n, 900, replace=False)] = rs.standard_normal(900)
    m = lil.tocsr()
    m.data = rs.standard_normal(m.nnz)
    h = pt.HostCSR.from_scipy(m)
    kw = dict(_BASE, stream_width=64, product_budget=1 << 12,
              stream_level_factor=F, stream_max_width=512)
    ptp, Ct, pj, Cj = _both(h, kw)
    _same(h, Ct, Cj)
    lt, lj = ptp.stream.lplans, pj.stream.lplans
    assert len(lt) == len(lj) >= 2 and lt[0].F == F
    for a, b in zip(lt, lj):
        assert (a.F, a.W_in) == (b.F, b.W_in)
        np.testing.assert_array_equal(a.in_map, b.in_map)
        np.testing.assert_array_equal(a.final_mask, b.final_mask)
        np.testing.assert_array_equal(a.segs_out, b.segs_out)
    assert ptp.stream.finish["ladder_levels"] == 0 or \
        ptp.stream.finish["ladder_levels"] == pj.stream.finish[
            "ladder_levels"]


def test_check_knobs_takes_what_the_reference_names():
    from speck_tpu_torch.ops.spgemm import check_knobs

    for kw in [dict(stream_sort_impl=s) for s in stream.SORT_IMPLS] + [
            dict(stream_compact_impl="scatter"),
            dict(stream_expand_impl="decode"), dict(stream_level_factor=3),
            dict(stream_level_factor=2)]:
        check_knobs(pt.SpgemmConfig(**kw))
    for kw in [dict(stream_sort_impl="quick"),
               dict(stream_compact_impl="heap"),
               dict(stream_expand_impl="gather"),
               dict(stream_level_factor=1)]:
        with pytest.raises(ValueError):
            check_knobs(pt.SpgemmConfig(**kw))


_MESH_KW = dict(stream_width=64, product_budget=1 << 10, stream_max_width=64)
KNOBS = [dict(stream_sort_impl="bitonic"), dict(stream_compact_impl="scatter"),
         dict(stream_expand_impl="decode"), dict(stream_level_factor=3)]


def _mesh_port(h, kw):
    from speck_tpu_torch.parallel import (make_row_mesh, mesh_stream_spgemm,
                                          mesh_stream_to_host_csr)

    out = mesh_stream_spgemm(h, h, make_row_mesh(4, devices=["cpu"]),
                             pt.SpgemmConfig(**kw), exchange="needset")
    assert out[3]["route"] == "stream"
    return mesh_stream_to_host_csr(*out)


@pytest.mark.parametrize("knob", KNOBS, ids=lambda k: str(list(k.values())[0]))
def test_mesh_under_each_knob(wide, knob):
    """The stream mesh (four CPU shards, need-set exchange, wide rows on
    its ladder) under each knob: the entries of its default call bit for
    bit (each knob is a permutation of the same entries or the same
    sort), the oracle's structure and values."""
    C = _mesh_port(wide, dict(_MESH_KW, **knob))
    _bits_equal(C, _mesh_port(wide, _MESH_KW))
    r = pt.compare_csr(pt.oracle_spgemm(wide, wide), C, compare_data=True,
                       rel_tol=2e-3)
    assert r.ok, r.message


def test_mesh_under_all_knobs_matches_the_reference(wide):
    """The reference mesh with all four knobs set (one compile): the
    port's structure and values equal to it."""
    from speck_tpu.parallel import make_row_mesh as mesh_j
    from speck_tpu.parallel import mesh_stream_spgemm as run_j
    from speck_tpu.parallel.mesh_stream import mesh_stream_to_host_csr as h_j

    kw = dict(_MESH_KW)
    for k in KNOBS:
        kw.update(k)
    hj = st.HostCSR.from_scipy(wide.to_scipy())
    Cj = h_j(*run_j(hj, hj, mesh_j(4), st.SpgemmConfig(**kw),
                    exchange="needset"))
    _same(wide, _mesh_port(wide, kw), Cj)
