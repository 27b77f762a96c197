"""The port's stage probes (speck_tpu_torch/probes: the ports of
scripts/profile_plan.py, mixed_probe.py, rect_probe.py, giant_probe.py,
ab_stream.py, dense_probe.py, micro2.py, slice_gather_bench.py and
ab_overlap.py) on the CPU at small sizes, where the kernels' wrappers run
their plain versions:

(a) every module imports with jax, speck_tpu and bench unimportable;
(b) each split returns the script's labels in the script's order, with
    finite times;
(c) what a split computes equals what the port's end-to-end call gives:
    execute() and the chunk probes' staged arrays equal the plan's, the
    dense stages compose to ``dense_tiles``'s output, the two exchanges
    of the mesh give the same C;
(d) the gathers that no other test holds, against the scripts' own JAX
    expressions (``jnp`` indexing, ``vmap`` of ``dynamic_slice``,
    ``lax.gather`` in CLIP mode): exactly equal, since they copy;
(e) ``main()`` raises without a card, before it makes a matrix.

No JAX compile of the stream path runs here."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speck_tpu_torch as pt
from speck_tpu_torch.ops.stream import build_srec, compact_staged
from speck_tpu_torch.probes import (ab_overlap, ab_stream, dense_probe,
                                    giant_probe, micro2, mixed_probe,
                                    profile_plan, rect_probe,
                                    slice_gather_bench)
from speck_tpu_torch.probes.split import chunk_is_raw
from speck_tpu_torch.utils import generators as gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("profile_plan", "mixed_probe", "rect_probe", "giant_probe",
         "ab_stream", "dense_probe", "micro2", "slice_gather_bench",
         "ab_overlap")
MODULES = dict(zip(NAMES, (profile_plan, mixed_probe, rect_probe,
                           giant_probe, ab_stream, dense_probe, micro2,
                           slice_gather_bench, ab_overlap)))
REPS = 2
# wide rows and a finish class at the small giant row; several chunks on
# the small stream inputs
GIANT_CFG = pt.SpgemmConfig(stream_width=256, product_budget=1 << 14)
STREAM_CFG = pt.SpgemmConfig(stream_width=256, product_budget=1 << 16)
RECT_CFG = pt.SpgemmConfig(enable_dense=False, stream_width=256,
                           product_budget=1 << 12)


def put(h):
    return pt.device_put_csr(h, torch.float32, device="cpu")


def assert_csr_equal(got, want):
    for f in ("indptr", "indices", "data"):
        assert torch.equal(getattr(got, f)[: got.nnz if f != "indptr"
                                           else None],
                           getattr(want, f)[: want.nnz if f != "indptr"
                                            else None]), f


def assert_tuple_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def products(h):
    b_len = np.diff(np.asarray(h.row_offsets, np.int64))
    return int(b_len[np.asarray(h.col_ids, np.int64)].sum())


# ---- the splits, each run once at a small size ----------------------------

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The probes run thousands of small torch ops here: on one thread,
    since more threads only spin-wait at each op, which costs minutes
    when the other test workers keep the cores busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def banded():
    return put(gen.make_banded(2048, 4))


@pytest.fixture(scope="module")
def giant():
    return put(gen.make_giant_row(mg=4000, NH=64, HN=512))


@pytest.fixture(scope="module")
def runs(banded, giant):
    """{case: (rows, context)} of every split at its small size."""
    out = {}
    out["profile_plan"] = (profile_plan.split(banded, reps=REPS), banded)
    lbc_cfg = dataclasses.replace(GIANT_CFG, host_analysis_max_nnz=16)
    out["profile_plan lbc"] = (profile_plan.lbc_split(giant, lbc_cfg, REPS),
                               lbc_cfg)
    mixed = put(gen.make_mixed(2048, 4, 24, 12))
    out["mixed_probe"] = (mixed_probe.split(mixed, reps=REPS), mixed)
    P = put(gen.make_prolongation(2048, 512))
    out["rect_probe"] = (rect_probe.split(banded, P, RECT_CFG, REPS), P)
    out["giant_probe"] = (giant_probe.split(giant, GIANT_CFG, REPS), None)
    h2 = gen.make_powerlaw(4096)
    out["ab_stream"] = (ab_stream.split(put(h2), STREAM_CFG, REPS), h2)
    plan = pt.plan_spgemm(banded, banded, pt.SpgemmConfig(enable_dia=False))
    out["dense_probe"] = (dense_probe.split(plan, REPS), plan)
    g_in = micro2.gather_inputs("cpu", 1 << 12, 1 << 11)
    out["micro2"] = (micro2.gather_split(*g_in, REPS)
                     + micro2.plan_split(banded, reps=REPS), g_in)
    s_in = slice_gather_bench.inputs(4096, 16, "cpu")
    out["slice_gather_bench"] = (slice_gather_bench.split(*s_in, 16, REPS),
                                 s_in)
    mesh = ab_overlap.mesh_of(torch.device("cpu"))
    out["ab_overlap"] = (ab_overlap.split(
        gen.make_powerlaw(2048, avg=8, seed=5), mesh, iters=1), mesh)
    return out


EXPECTED = {
    "profile_plan": profile_plan.LABELS,
    "mixed_probe": mixed_probe.LABELS,
    "rect_probe": rect_probe.LABELS,
    "giant_probe": giant_probe.LABELS,
    "ab_stream": ab_stream.LABELS,
    "dense_probe": dense_probe.LABELS,
    "micro2": micro2.GATHER_LABELS + micro2.PLAN_LABELS,
    "slice_gather_bench": slice_gather_bench.LABELS,
    "ab_overlap": ab_overlap.MODES,
}
SCRIPT_LABELS = {
    "giant_probe": ("full plan_spgemm", "expand only", "expand+sort[xla]",
                    "expand+sort[blocked]", "expand+sort[auto]",
                    "full chunk (stage, compact)[xla]",
                    "full chunk (stage, compact)[auto]"),
    "mixed_probe": ("complete", "host_analyze",
                    "plan_device_stream dia_rows=True dense=True",
                    "plan_device_stream dia_rows=False dense=True",
                    "plan_device_stream dia_rows=False dense=False"),
    "ab_stream": ("config2 xla/sort", "config2 bitonic/sort",
                  "config2 bitonic_pallas/sort"),
    "slice_gather_bench": ("A element gather", "B slice gather",
                           "C packed element gather",
                           "D packed slice gather", "E lax.gather slices"),
}


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_split_labels_in_script_order(runs, case):
    rows = runs[case][0]
    assert tuple(r[0] for r in rows) == EXPECTED[case]
    want = SCRIPT_LABELS.get(case, ())
    assert tuple(r[0] for r in rows[: len(want)]) == want
    for _, med, mn, _ in rows:
        assert math.isfinite(med) and math.isfinite(mn) and 0 <= mn <= med


def test_lbc_split_runs_plan_spgemms_steps_in_order(runs):
    rows, cfg = runs["profile_plan lbc"]
    labels = [r[0] for r in rows]
    order = [profile_plan.ROW_ENDS_LABEL, "lite gate: host_band_extremes",
             "analyze (countProducts)",
             "host gate: _host_dense_plausible",
             "host gate: _host_dia_rows_plausible", "plan_device_stream",
             "pack readback",
             "host_layout (plan_layout, plan_levels, _plan_accum)",
             "build_srec, searchsorted", profile_plan.LBC_LABEL]
    assert [lab for lab in labels if lab in order] == order
    assert all(lab in order or lab.startswith("lite gate: ")
               for lab in labels)
    for _, med, mn, _ in rows:
        assert math.isfinite(med) and 0 <= mn <= med
    stages = rows[-1][3]
    assert stages["loadBalanceCounting"] > 0
    assert "loadBalanceCounting" in profile_plan.sum_line(rows, "cpu")


def test_lbc_split_of_a_stencil_encloses_its_diagonal_plan():
    S = put(gen.make_stencil27(8))
    rows = profile_plan.lbc_split(
        S, pt.SpgemmConfig(host_analysis_max_nnz=16), 1)
    assert [r[0] for r in rows] == [
        profile_plan.ROW_ENDS_LABEL,
        "lite gate: host_band_extremes", "lite gate: host_gate_lite",
        "lite gate: _dia_spans", "lite gate: _sdia_gate",
        profile_plan.TOTAL_LABEL,
        "_plan_sdia (spGEMMCounting, allocC)", profile_plan.LBC_LABEL]
    assert rows[5][3] == rows[6][3].sum_products
    assert_csr_equal(rows[6][3].execute(), pt.spgemm(
        S, S, pt.SpgemmConfig(host_analysis_max_nnz=16)))


def test_lbc_split_refuses_an_input_of_the_host_analysis(banded):
    with pytest.raises(ValueError, match="host_analysis_max_nnz"):
        profile_plan.lbc_split(banded, reps=1)


def test_lbc_split_stream_parts_equal_the_plans(runs, giant):
    rows, cfg = runs["profile_plan lbc"]
    by = {r[0]: r[3] for r in rows}
    plan = pt.plan_spgemm(giant, giant, cfg)
    layout = by["host_layout (plan_layout, plan_levels, _plan_accum)"][0]
    assert layout == plan.stream.layout
    srec = by["build_srec, searchsorted"]
    ss = plan.stream
    r = ss.rec
    assert_tuple_equal(srec, (r.p0, r.su, r.sa, r.src, r.pend, r.sid_bases))


# ---- (c) the outputs against the port's own calls -------------------------

def test_profile_plan_outputs_equal_the_plans(runs):
    rows, A = runs["profile_plan"]
    by = {r[0]: r[3] for r in rows}
    plan = pt.plan_spgemm(A, A)
    C = pt.spgemm(A, A)
    assert_csr_equal(by["dia execute()"], C)
    _, _, cols_s, vals_s = by["dia_count_stage"]
    assert_tuple_equal((cols_s, vals_s), plan.dia.staged)
    c_cols, c_vals = by["dia dense_gather_emit"]
    assert torch.equal(c_cols, C.indices[: C.nnz])
    assert torch.equal(c_vals, C.data[: C.nnz])


def test_mixed_probe_execute_equals_the_complete_call(runs):
    rows, A = runs["mixed_probe"]
    by = {r[0]: r[3] for r in rows}
    plan = by["routes"]
    assert plan.dia_rows is not None and plan.stream is not None
    assert_csr_equal(by["execute (staged)"], by["complete"])
    assert "dia_rows=True" in mixed_probe.routes_line(plan)


def _chunks_equal_the_plans(plan, staged_by_chunk, n_products):
    for c, (nnz_row, stg) in staged_by_chunk:
        want = plan.stream.staged[c]
        if chunk_is_raw(plan, c) and plan.nnz != n_products:
            stg = compact_staged(*stg, n_cols=plan.shape[1])
        assert_tuple_equal(stg, want)


def test_rect_probe_chunks_and_records_equal_the_plans(runs, banded):
    rows, P = runs["rect_probe"]
    by = {r[0]: r[3] for r in rows}
    plan = by["layout"]
    ss = plan.stream
    r = ss.rec
    assert ss.layout.n_chunks > 1
    chunks = by["counting chunks"]
    _chunks_equal_the_plans(plan, enumerate(chunks),
                            products(pt.device_get_csr(banded)))
    assert_tuple_equal(by["build_srec (compact=True, pack=False)"],
                       (r.p0, r.su, r.sa, r.src, r.pend))
    unpacked = build_srec(
        banded.indptr, banded.indices, banded.data.view(torch.int32),
        P.indptr[:-1], P.indptr[1:] - P.indptr[:-1], ss.rows_sorted, ss.e,
        ss.q_sorted, m=plan.shape[0], nl=r.p0.shape[0], compact=False)
    assert_tuple_equal(by["build_srec (compact=False, pack=True)"], unpacked)
    assert_tuple_equal(by["build_srec (compact=True, pack=True)"],
                       (r.p0, r.su, r.sa, r.src, r.pend))
    assert_tuple_equal(by["build_srec (compact=False, pack=False)"], unpacked)
    assert_csr_equal(by["execute (staged gather emit)"],
                     by["spgemm complete"])


def test_giant_probe_chunk_equals_the_plans(runs):
    rows = runs["giant_probe"][0]
    by = {r[0]: r[3] for r in rows}
    plan = by["full plan_spgemm"]
    ss = plan.stream
    assert ss.layout.n_wide > 0 and ss.finish["classes"]
    for s in giant_probe.CHUNK_SORTS:
        _chunks_equal_the_plans(
            plan, [(0, by[f"full chunk (stage, compact)[{s}]"])], 0)
    lplans, classes = by["level plans and finish classes"]
    assert len(lplans) == len(ss.lplans)
    assert classes == [(f["R2"], f["W2"]) for f in ss.finish["classes"]]
    srt = [by[f"expand+sort[{s}]"] for s in giant_probe.SORTS]
    for other in srt[1:]:
        assert_tuple_equal(other, srt[0])


def test_ab_stream_outputs_equal_the_plans(runs):
    rows, h = runs["ab_stream"]
    by = {r[0]: r[3] for r in rows}
    plan = by["layout"]
    c = min(1, plan.stream.layout.n_chunks - 1)
    assert c == 1
    _chunks_equal_the_plans(plan, [(c, by["full chunk (stage_raw)"])],
                            products(h))
    C = by["execute() fused"]
    for name, _ in ab_stream.VARIANTS:
        assert_csr_equal(by[f"config2 {name}"], C)
    cols, vals = by["gather emit"]
    assert cols.shape[0] == plan.nnz + 1 and vals.shape[0] == plan.nnz + 1


def test_dense_probe_stages_compose_to_dense_tiles(runs):
    rows, plan = runs["dense_probe"]
    by = {r[0]: r[3] for r in rows}
    _, whole = by["dense_tiles whole"]
    assert_tuple_equal(by["compaction sort"], whole)
    assert_tuple_equal(whole, plan.dense_staged[0])


def test_ab_overlap_exchanges_give_the_same_c(runs):
    rows, mesh = runs["ab_overlap"]
    ab_overlap.check_equal(rows)
    ref = pt.oracle_spgemm(*(2 * [gen.make_powerlaw(2048, avg=8, seed=5)]))
    got = ab_overlap.host_c(rows[1])
    assert pt.compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok
    assert rows[0][3]["nnz"] == rows[1][3]["nnz"] == ref.nnz
    entries, before, ranges = ab_overlap.schedule(*rows[1][3]["step"])
    assert ranges and entries == [] and before is None   # no card here


def test_ab_overlap_reports(runs, tmp_path):
    rows, mesh = runs["ab_overlap"]
    sched = ([("K2", "radix_tile_kernel", None),
              ("exchange copy", "Memcpy DtoD", "land round 1")], 1, [])
    ab_overlap.write_reports(rows, sched, 2048, 1, mesh, "cpu", tmp_path)
    text = (tmp_path / "overlap_ab.md").read_text()
    assert "| needset |" in text and "share one card" in text
    assert "1 K2 sorts before" in text
    assert len((tmp_path / "overlap_sched.txt").read_text().splitlines()) \
        == 3


# ---- (d) the gathers against the scripts' JAX expressions ----------------

def test_micro2_gathers_equal_their_jnp_forms(runs):
    rows, (cols, vals, src) = runs["micro2"]
    jc, jv, js = (jnp.asarray(x.numpy()) for x in (cols, vals, src))
    packed2 = jnp.stack([jc, jax.lax.bitcast_convert_type(jv, jnp.int32)],
                        axis=-1)

    @jax.jit
    def g_rows(s):
        r = packed2[s]
        return r[:, 0], jax.lax.bitcast_convert_type(r[:, 1], jnp.float32)

    @jax.jit
    def g_two(s):
        return jc[s], jv[s]

    for (got_c, got_v), fn in zip((rows[0][3], rows[1][3]), (g_rows, g_two)):
        want_c, want_v = fn(js)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                      np.asarray(want_v).view(np.int32))


def test_slice_gathers_equal_the_scripts_jax_expressions():
    M, RW = 4096, 16
    tab, tab2, idx, st = slice_gather_bench.inputs(M, RW, "cpu")
    NN = tab.shape[0]
    st = st.clone()
    st[0], st[1], st[2] = NN - 3, NN - RW, 0   # past the end: clamped
    got = [r[3] for r in slice_gather_bench.split(tab, tab2, idx, st, RW, 1)]
    jt, jt2, ji, js = (jnp.asarray(x.numpy()) for x in (tab, tab2, idx, st))

    def slice_g(t_, s_):
        return jax.vmap(lambda s: jax.lax.dynamic_slice(t_, (s,), (RW,)))(s_)

    def slice_g2(t_, s_):
        return jax.vmap(
            lambda s: jax.lax.dynamic_slice(t_, (s, 0), (RW, 2)))(s_)

    dn = jax.lax.GatherDimensionNumbers(offset_dims=(1,),
                                        collapsed_slice_dims=(),
                                        start_index_map=(0,))

    def lg(t_, s_):
        return jax.lax.gather(t_, s_[:, None], dn, slice_sizes=(RW,),
                              mode=jax.lax.GatherScatterMode.CLIP)

    want = [jax.jit(lambda t_, i_: t_[i_])(jt, ji),
            jax.jit(slice_g)(jt, js),
            jax.jit(lambda t_, i_: t_[i_])(jt2, ji),
            jax.jit(slice_g2)(jt2, js),
            jax.jit(lg)(jt, js)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[1][0].numpy(),
                                  tab[NN - RW:].numpy())


# ---- (a) imports, (e) main without a card --------------------------------

@pytest.fixture(scope="module")
def imports():
    code = (
        "import importlib, json, sys\n"
        "for m in ('jax', 'speck_tpu', 'bench'):\n"
        "    sys.modules[m] = None\n"
        "res = {}\n"
        f"for name in {NAMES!r}:\n"
        "    try:\n"
        "        mod = importlib.import_module('speck_tpu_torch.probes.' "
        "+ name)\n"
        "        res[name] = 'ok' if callable(getattr(mod, 'main', None)) "
        "else 'no main'\n"
        "    except Exception as e:\n"
        "        res[name] = repr(e)\n"
        "res['_loaded'] = sorted(m for m in sys.modules if m.startswith("
        "('jax.', 'speck_tpu.')) and sys.modules[m] is not None)\n"
        "print(json.dumps(res))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", NAMES)
def test_probe_imports_without_jax(imports, name):
    assert imports[name] == "ok"
    assert imports["_loaded"] == []


@pytest.mark.parametrize("name", NAMES)
def test_main_without_a_card_raises_before_making_a_matrix(monkeypatch,
                                                           name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")

    def no_matrix(*a, **k):
        raise AssertionError("main made a matrix before it checked the card")

    monkeypatch.setattr(np.random, "RandomState", no_matrix)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MODULES[name].main([])
