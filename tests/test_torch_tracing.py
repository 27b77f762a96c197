"""The port's instrumentation on the CPU: the profiler ranges of a call and
their nesting, no range without a profiler, the stage timings the ranges
leave alone, the readback and route counters, the kernels' live slots
against the products scipy counts, and the value planes moved by slot."""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import speck_tpu_torch as pt
from speck_tpu_torch.formats.csr import HostCSR
from speck_tpu_torch.ops import bitonic as tbitonic
from speck_tpu_torch.ops import stream as tstream
from speck_tpu_torch.utils import timings as tt
from speckbench import trace as tr
from speckbench.window import SpanTimings

tsp = importlib.import_module("speck_tpu_torch.ops.spgemm")

CPU = torch.device("cpu")
STREAM = dict(enable_dense=False, enable_dia=False, enable_sdia=False,
              dia_rows=False, stream_width=64, product_budget=1 << 10)
# wide rows past stream_max_width: merge levels; a small staging budget:
# the two-phase numeric chunks
CASES = {"fused": dict(STREAM, stream_max_width=256),
         "two_phase": dict(STREAM, stream_max_width=1 << 24,
                           fused_staging_budget=1 << 10)}


def wide_matrix(n=300, seed=5, singles=False):
    """Random n x n at density 0.05 plus two dense rows (wide at W=64);
    ``singles``: some rows of one entry (the direct route)."""
    rs = np.random.RandomState(seed)
    lil = sp.random(n, n, 0.05, format="csr", random_state=rs).tolil()
    lil[0, :] = rs.standard_normal(n)
    lil[7, :200] = 1.0
    if singles:
        for r in range(20, 60):
            lil[r, :] = 0
            lil[r, r] = 2.0
    mat = lil.tocsr()
    mat.eliminate_zeros()
    mat.data = rs.standard_normal(mat.nnz).astype(np.float32)
    return mat


def put(mat, dtype=torch.float32):
    return pt.device_put_csr(HostCSR.from_scipy(mat), dtype, device=CPU)


def ranges_of(fn):
    """The ``speck.*`` ranges ``fn`` opens under the CPU profiler, as
    (name, start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("speck.")]


def inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranges_nest_under_their_stages(case):
    mat = wide_matrix()
    A, cfg = put(mat), pt.SpgemmConfig(**CASES[case])
    pt.spgemm(A, A, cfg)
    rs = ranges_of(lambda: pt.spgemm(A, A, cfg))
    plan = pt.plan_spgemm(A, A, cfg)
    lo = plan.stream.layout
    names = [r[0] for r in rs]
    stage = {n: [r for r in rs if r[0] == "speck." + n]
             for n in ("countProducts", "loadBalanceCounting",
                       "spGEMMCounting", "allocC", "spGEMMNumeric")}
    assert all(len(v) >= 1 for v in stage.values())

    def under(name, *stages):
        got = [r for r in rs if r[0] == name]
        assert got, name
        for r in got:
            assert any(inside(r, s) for st in stages for s in stage[st]), (
                name, stages)
        return got

    assert len(under("speck.count.chunk", "spGEMMCounting")) == lo.n_chunks
    under("speck.plan.host_analyze", "countProducts")
    for n in ("speck.plan.device_plan", "speck.plan.host_layout",
              "speck.plan.groups", "speck.plan.records",
              "speck.readback.plan_pack"):
        under(n, "loadBalanceCounting")
    under("speck.readback.nnz_meta", "allocC")
    under("speck.readback.wide_totals", "spGEMMCounting")
    if case == "fused":
        levels = under("speck.wide.level", "spGEMMCounting")
        assert len(levels) == len(plan.stream.lplans)
        assert "speck.numeric.chunk" not in names
    else:
        assert len(under("speck.numeric.chunk", "spGEMMNumeric")
                   ) == lo.n_chunks
        under("speck.wide.finish", "spGEMMCounting", "spGEMMNumeric")
    under("speck.emit", "spGEMMNumeric")
    assert names.count("speck.route.stream") == 1
    # a chunk's ranges do not overlap one another
    chunks = sorted(r[1:] for r in rs if r[0] == "speck.count.chunk")
    assert all(a[1] <= b[0] for a, b in zip(chunks, chunks[1:]))


def test_no_range_without_a_profiler(monkeypatch):
    opened = []
    real = tt.record_function
    monkeypatch.setattr(tt, "record_function",
                        lambda name: opened.append(name) or real(name))
    A, cfg = put(wide_matrix()), pt.SpgemmConfig(**CASES["two_phase"])
    assert pt.spgemm(A, A, cfg).nnz > 0 and opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        pt.spgemm(A, A, cfg)
    assert opened and all(n.startswith("speck.") for n in opened)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sub_ranges_leave_the_stage_timings(case):
    """The stage spans that ``trace.self_times`` reads (plan_ms, count_ms,
    numeric_ms) are the same stages, in the same order, under the
    profiler's sub-ranges as without them: no sub-range reaches a
    ``Timings``."""
    A, cfg = put(wide_matrix()), pt.SpgemmConfig(**CASES[case])
    plain, ranged = SpanTimings(), SpanTimings()
    pt.spgemm(A, A, cfg, timings=plain)
    with profile(activities=[ProfilerActivity.CPU]):
        pt.spgemm(A, A, cfg, timings=ranged)
    assert [s[0] for s in ranged.spans] == [s[0] for s in plain.spans]
    assert set(tr.self_times(ranged.spans)) <= set(tt.STAGE_NAMES)
    assert set(tr.self_times(plain.spans)) == set(
        tr.self_times(ranged.spans))


def scipy_products(mat, rows=None):
    lens = np.diff(mat.indptr)
    per_row = np.add.reduceat(lens[mat.indices], mat.indptr[:-1])
    per_row[lens == 0] = 0
    return int(per_row.sum() if rows is None else per_row[rows].sum())


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_live_counts_are_the_products(monkeypatch, case, direct):
    """Every chunk launch of the stream carries a live count; over a
    call's counting chunks they sum to the stream's products (scipy's,
    less the direct rows' where those take the direct route), and a merge
    level's or a finish class's count is its real entries."""
    mat = wide_matrix(singles=direct)
    A = put(mat)
    cfg = pt.SpgemmConfig(enable_direct=direct, **CASES[case])
    calls = []
    orig_c, orig_s = tstream.stream_contract, tstream.row_sort

    def contract(rid, col, val, n_cols, live=None):
        calls.append(("k1", rid.stride(1) == 0, live,
                      int((col < n_cols).sum()), col.numel()))
        return orig_c(rid, col, val, n_cols, live)

    def sort(key, payloads=(), live=None):
        calls.append(("k2", None, live, None, key.numel()))
        return orig_s(key, payloads, live)

    monkeypatch.setattr(tstream, "stream_contract", contract)
    monkeypatch.setattr(tstream, "row_sort", sort)
    plan = pt.plan_spgemm(A, A, cfg)
    chunk = [c for c in calls if c[0] == "k1" and not c[1]]
    wide = [c for c in calls if c[0] == "k1" and c[1]]
    assert chunk and wide and all(c[2] is not None for c in calls
                                  if c[0] == "k1")
    single = np.flatnonzero(np.diff(mat.indptr) == 1) if direct else []
    rows = np.setdiff1d(np.arange(mat.shape[0]), single)
    assert sum(c[2] for c in chunk) == sum(c[3] for c in chunk) == (
        scipy_products(mat, rows))
    assert plan.stream.products == scipy_products(mat, rows)
    assert all(c[2] == c[3] for c in wide)
    assert all(0 <= c[2] <= c[4] for c in calls if c[2] is not None)
    # the numeric pass carries the same counts
    calls.clear()
    plan.execute(A, A)
    chunk_n = [c for c in calls if c[0] == "k1" and not c[1]]
    assert sum(c[2] for c in chunk_n) == scipy_products(mat, rows)


def test_live_count_none_without_host_products():
    """With direct rows and no host analysis the host cannot tell the
    stream's products from the pack: no live count."""
    A = put(wide_matrix(singles=True))
    plan = pt.plan_spgemm(A, A, pt.SpgemmConfig(host_analysis=False,
                                                **CASES["fused"]))
    assert plan.stream.products is None
    assert tsp.chunk_live(plan.stream.layout, None, 0) is None


def test_chunk_shares_sum_exactly():
    lo = tstream.plan_layout(np.zeros(32, np.int64), np.zeros(32, np.int64),
                             64, 1 << 10, total_q=64 * 16 * 5 + 192,
                             n_wide=0, r_wide=0, wide_segs=np.zeros(0))
    for products in (0, 1, 7, lo.total_q // 3, lo.total_q):
        shares = [tsp.chunk_live(lo, products, c)
                  for c in range(lo.n_chunks)]
        assert sum(shares) == products
        assert all(0 <= s <= lo.G * lo.W for s in shares)


def readbacks_of(fn):
    before = {k: list(v) for k, v in tt.READBACKS.items()}
    fn()
    return {k: v[0] - before.get(k, [0, 0])[0]
            for k, v in tt.READBACKS.items()
            if v[0] > before.get(k, [0, 0])[0]}


def test_readbacks_of_a_call():
    A, cfg = put(wide_matrix()), pt.SpgemmConfig(**CASES["fused"])
    finish = pt.plan_spgemm(A, A, cfg).stream.finish
    got = readbacks_of(lambda: pt.spgemm(A, A, cfg))
    # the pack, the wide totals before each merge level (and once more
    # where a finish ends the ladder), C's meta
    assert finish["ladder_levels"] == 6 and finish["classes"] is None
    assert got == {"plan_pack": 1, "wide_totals": 6, "nnz_meta": 1}
    plan = pt.plan_spgemm(A, A, cfg)
    assert readbacks_of(lambda: plan.execute(A, A)) == {}
    b = tt.READBACKS["plan_pack"][1]
    assert b > 0 and b % 4 == 0


def test_readback_counts_bytes_and_copies():
    t = torch.arange(6, dtype=torch.int64)
    got = readbacks_of(lambda: np.testing.assert_array_equal(
        tt.readback(t, "test_probe"), np.arange(6)))
    assert got == {"test_probe": 1}
    assert tt.READBACKS["test_probe"][1] % 48 == 0


@pytest.mark.parametrize("route,cfg", [
    ("stream", CASES["fused"]),
    ("dia", dict()),
    ("blocked", dict(CASES["fused"], block_products=1 << 14)),
])
def test_routes_are_counted_and_marked(route, cfg):
    mat = (sp.diags([1.0, 2.0, 3.0], [-1, 0, 1], shape=(200, 200),
                    format="csr", dtype=np.float32) if route == "dia"
           else wide_matrix())
    A = put(mat)
    before = dict(tsp.ROUTES)
    rs = ranges_of(lambda: pt.spgemm(A, A, pt.SpgemmConfig(**cfg)))
    assert tsp.ROUTES[route] == before.get(route, 0) + 1
    assert "speck.route." + route in [r[0] for r in rs]


@pytest.fixture()
def one_thread():
    """A 16-bit call's many small torch ops on one thread: more threads
    only spin-wait at each op when the other test workers keep the cores
    busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def by_slot_of(fn):
    """What ``fn`` adds to ``bitonic.BY_SLOT``."""
    before = {k: list(v) for k, v in tbitonic.BY_SLOT.items()}
    fn()
    return {k: [a - b for a, b in zip(v, before.get(k, [0, 0]))]
            for k, v in tbitonic.BY_SLOT.items()
            if v != before.get(k, [0, 0])}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64, torch.float32])
def test_by_slot_counts_planes_of_16_and_64_bits(dtype):
    """A sort moves a 16- or 64-bit plane by its slot, one gather of R * W
    slots counted under the type's name; a 32-bit plane rides the sort
    and counts nothing. The values land where a plain sort puts them."""
    g = torch.Generator().manual_seed(3)
    col = torch.randint(0, 50, (4, 96), generator=g, dtype=torch.int32)
    val = torch.randn(4, 96, generator=g).to(dtype)
    out = []
    got = by_slot_of(lambda: out.append(tstream._sort_cols(col, val)))
    name = str(dtype).replace("torch.", "")
    assert got == ({} if dtype.itemsize == 4 else {name: [1, 4 * 96]})
    perm = torch.sort(col, dim=1, stable=True).indices
    assert torch.equal(out[0][0], torch.gather(col, 1, perm))
    assert torch.equal(out[0][1], torch.gather(val, 1, perm))


def test_by_slot_range_only_under_a_profiler(monkeypatch, one_thread):
    """A 16-bit call opens ``speck.values.by_slot`` inside its stages under
    the profiler, as many times as it counts gathers, and opens no range
    without it; a float32 call gathers nothing by slot."""
    A = put(wide_matrix(), torch.bfloat16)
    cfg = pt.SpgemmConfig(**CASES["two_phase"])
    opened = []
    real = tt.record_function
    monkeypatch.setattr(tt, "record_function",
                        lambda name: opened.append(name) or real(name))
    assert by_slot_of(lambda: pt.spgemm(A, A, cfg))["bfloat16"][0] > 0
    assert opened == []
    got = {}
    rs = ranges_of(lambda: got.update(by_slot_of(
        lambda: pt.spgemm(A, A, cfg))))
    mine = [r for r in rs if r[0] == "speck.values.by_slot"]
    assert len(mine) == got["bfloat16"][0] > 0
    stages = [r for r in rs if r[0] in ("speck.spGEMMCounting",
                                        "speck.allocC",
                                        "speck.spGEMMNumeric")]
    assert all(any(inside(r, s) for s in stages) for r in mine)
    f32 = put(wide_matrix())
    assert by_slot_of(lambda: pt.spgemm(f32, f32, cfg)) == {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_by_slot_adds_no_readback_or_stage(case, one_thread):
    """The gathers by slot copy nothing to the host and reach no
    ``Timings``: a 16-bit call's readbacks and stage spans under the
    profiler are those without it."""
    A = put(wide_matrix(), torch.bfloat16)
    cfg = pt.SpgemmConfig(**CASES[case])
    plain, ranged = SpanTimings(), SpanTimings()
    quiet = readbacks_of(lambda: pt.spgemm(A, A, cfg, timings=plain))

    def profiled():
        with profile(activities=[ProfilerActivity.CPU]):
            pt.spgemm(A, A, cfg, timings=ranged)

    assert readbacks_of(profiled) == quiet
    assert [s[0] for s in ranged.spans] == [s[0] for s in plain.spans]
    assert set(tr.self_times(ranged.spans)) <= set(tt.STAGE_NAMES)
