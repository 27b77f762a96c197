"""The port's row mesh against speck_tpu's on the CPU.

The same seeded numpy inputs go through ``speck_tpu.parallel`` on the
conftest's 8-device CPU mesh (``make_row_mesh(D)``) and through
``speck_tpu_torch.parallel`` with ``make_row_mesh(D, devices=["cpu"])``:
``meta`` equal field by field (``compiled_reused`` apart: it depends on
each package's step cache and is tested on its own), ``nnz_row`` equal,
each shard's columns equal within its rows' counts, values within rtol
2e-3 of JAX's in float32 (the reference's own tolerance) and 1e-12 in
float64 (JAX under ``jax_enable_x64``, restored after), and every result
within rel_tol 2e-3 (float32) or 1e-9 (float64) of the scipy oracle. The
cases are those of ``tests/test_parallel.py``; those of the mesh's
diagonal-plane, dense and overlapped routes are in
``tests/test_torch_mesh_routes.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import speck_tpu.parallel as jp
import speck_tpu_torch.parallel as tp
from conftest import random_host_csr
from speck_tpu.formats.csr import HostCSR as JHostCSR
from speck_tpu.parallel import dist as jdist
from speck_tpu.parallel import mesh_stream as jms
from speck_tpu.utils.config import SpgemmConfig as JConfig
from speck_tpu_torch.entry import dryrun_inputs, dryrun_multichip
from speck_tpu_torch.formats.csr import HostCSR
from speck_tpu_torch.parallel import dist as tdist
from speck_tpu_torch.parallel import mesh_stream as tms
from speck_tpu_torch.parallel import multihost as tmh
from speck_tpu_torch.utils.compare import compare_csr
from speck_tpu_torch.utils.config import SpgemmConfig as TConfig
from speck_tpu_torch.utils.oracle import oracle_spgemm

ORACLE_TOL = {np.float32: 2e-3, np.float64: 1e-9}
JAX_TOL = {np.float32: 2e-3, np.float64: 1e-12}
META_KEYS = ("m_loc", "out_cap", "shape", "route", "ksplit")


@pytest.fixture()
def x64():
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _port(h):
    """The port's HostCSR of a reference HostCSR (and back: same fields)."""
    return HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                   col_ids=h.col_ids, data=h.data)


def _jax(h):
    return JHostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                    col_ids=h.col_ids, data=h.data)


def _tmesh(D):
    return tp.make_row_mesh(D, devices=["cpu"])


def _check_meta(jm, tm):
    for k in META_KEYS:
        assert jm[k] == tm[k], (k, jm[k], tm[k])
    assert [tuple(r) for r in jm["ranges"]] == \
        [tuple(r) for r in tm["ranges"]]
    js, ts = jm["stats"], tm["stats"]
    assert (js is None) == (ts is None)
    if js is not None:
        assert js.allgather_bytes == ts.allgather_bytes
        assert js.needset_bytes == ts.needset_bytes
        assert js.mode == ts.mode
        np.testing.assert_array_equal(js.pairs_nnz, ts.pairs_nnz)


def _check_out(jo, to, D, np_dtype):
    """meta, nnz_row, columns and values of the two packages' outputs."""
    _check_meta(jo[3], to[3])
    jn = np.asarray(jo[0]).reshape(D, -1)
    tn = tdist.fetch_output(to[0]).reshape(D, -1)
    np.testing.assert_array_equal(tn, jn)
    jc = np.asarray(jo[1]).reshape(D, -1)
    tc = tdist.fetch_output(to[1]).reshape(D, -1)
    jv = np.asarray(jo[2]).reshape(D, -1)
    tv = tdist.fetch_output(to[2]).reshape(D, -1)
    assert tv.dtype == np_dtype
    for d in range(D):
        tot = int(jn[d].sum())
        np.testing.assert_array_equal(tc[d, :tot], jc[d, :tot])
        np.testing.assert_allclose(tv[d, :tot], jv[d, :tot],
                                   rtol=JAX_TOL[np_dtype],
                                   atol=JAX_TOL[np_dtype] * 1e-2)


def _both(a, b, D, exchange, kw=None, np_dtype=np.float32, presharded=False):
    """Run both packages on (a, b) over D shards; check them against each
    other and the port against the oracle. Returns (jax out, port out)."""
    kw = kw or {}
    ja, jb = _jax(a), _jax(b)
    ta, tb = _port(a), _port(b)
    if presharded:
        ja, jb = jms.RowShards.from_global(ja, D), jms.RowShards.from_global(
            jb, D)
        ta, tb = tms.RowShards.from_global(ta, D), tms.RowShards.from_global(
            tb, D)
    jdt = jnp.float64 if np_dtype == np.float64 else jnp.float32
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    jo = jp.mesh_stream_spgemm(ja, jb, jp.make_row_mesh(D), JConfig(**kw),
                               exchange=exchange, dtype=jdt)
    to = tp.mesh_stream_spgemm(ta, tb, _tmesh(D), TConfig(**kw),
                               exchange=exchange, dtype=tdt)
    _check_out(jo, to, D, np_dtype)
    got = tp.mesh_stream_to_host_csr(*to)
    r = compare_csr(oracle_spgemm(_port(a), _port(b)), got,
                    compare_data=True, rel_tol=ORACLE_TOL[np_dtype])
    assert r.ok, r.message
    return jo, to


# ---------------------------------------------------------------------------
# inputs (the reference tests' constructions)
# ---------------------------------------------------------------------------


def _powerlaw(seed=3, m=512, avg=6):
    rng = np.random.default_rng(seed)
    lens = np.minimum(((rng.pareto(1.8, m) + 1) * avg * 0.5).astype(int),
                      m // 2)
    lens[0] = m // 2  # one hot row
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    return JHostCSR.from_scipy(mat)


def _with_rows(m, density, seed, rows_full=(), rows_half=()):
    rs = np.random.RandomState(seed)
    base = sp.random(m, m, density, format="csr", random_state=rs)
    base.data = rs.standard_normal(base.nnz)
    lil = base.tolil()
    for r in rows_full:
        lil[r, :] = rs.standard_normal(m)
    for r in rows_half:
        lil[r, ::2] = rs.standard_normal(m // 2)
    return JHostCSR.from_scipy(lil.tocsr())


def _skewed(rng, m=1024, heavy=64, heavy_len=96, avg=6):
    lens = np.full(m, avg, np.int64)
    lens[:heavy] = heavy_len
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    return JHostCSR.from_scipy(mat)


def _blockperm(m=512, blk=64, nnz_per_row=8, seed=23):
    rs = np.random.RandomState(seed)
    nb = m // blk
    rows = np.repeat(np.arange(m), nnz_per_row)
    pick = np.argsort(rs.random((m, blk)), axis=1)[:, :nnz_per_row]
    pd0 = (nb - 1 - (np.arange(m) // blk)) * blk
    cols = (pd0[:, None] + pick).reshape(-1)
    vals = rs.standard_normal(rows.shape[0])
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    return JHostCSR.from_scipy(mat)


# the k-split / ladder inputs of test_parallel.py, shared across cases
KSPLIT = dict(m=240, density=0.08, seed=33, rows_full=(17,),
              rows_half=(100,))
KSPLIT_CFG = dict(stream_width=64, product_budget=1 << 14,
                  mesh_split_min_ops=900)


# ---------------------------------------------------------------------------
# dist.py
# ---------------------------------------------------------------------------


def test_partition_rows():
    assert tp.partition_rows(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert tp.partition_rows(3, 8)[-1] == (3, 3)
    for m, n in [(10, 4), (3, 8), (37, 8), (0, 4)]:
        assert tp.partition_rows(m, n) == jp.partition_rows(m, n)


def test_make_row_mesh_devices():
    mesh = tp.make_row_mesh(4, devices=["cpu"])
    assert mesh.size == 4 and mesh.local == (0, 1, 2, 3)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        tp.make_row_mesh(4, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        # the default is every CUDA card: never the CPU
        with pytest.raises(RuntimeError):
            tp.make_row_mesh(4)
    assert set(jp.__all__) <= set(tp.__all__)
    assert "padded_to_host_csr" in tp.__all__


def test_stack_row_shards_identity_layout(rng):
    a = random_host_csr(rng, 13, 9, 0.3)
    got = tdist.stack_row_shards(_port(a), 4)
    want = jdist.stack_row_shards(a, 4)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3] == want[3]
    indptr = got[0]
    m_loc = indptr.shape[1] - 1
    assert m_loc == 4
    for k in [0, 3, 4, 12]:
        d, s = divmod(k, m_loc)
        assert indptr[d, s + 1] - indptr[d, s] == \
            a.row_offsets[k + 1] - a.row_offsets[k]
    assert indptr[3, 2] == indptr[3, 1]


@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_spgemm(n_dev):
    """Each device's spgemm on its A slice: the rows of speck_tpu's
    single-device product of the whole matrix (one JAX plan for both
    device counts)."""
    import speck_tpu as st

    a = random_host_csr(np.random.default_rng(70), 70, 70, 0.1)
    ref = oracle_spgemm(_port(a), _port(a))
    A = st.device_put_csr(a)
    wh = st.device_get_csr(st.spgemm(A, A, JConfig(product_budget=1 << 14)))
    got = tp.distributed_spgemm(_port(a), _port(a), devices=["cpu"] * n_dev,
                                cfg=TConfig(product_budget=1 << 14))
    assert got.row_ranges == jp.partition_rows(70, n_dev)
    gh = got.to_host()
    np.testing.assert_array_equal(gh.row_offsets, wh.row_offsets)
    np.testing.assert_array_equal(gh.col_ids, wh.col_ids)
    np.testing.assert_allclose(gh.data, wh.data, rtol=2e-3, atol=1e-5)
    assert compare_csr(ref, gh, compare_data=True, rel_tol=2e-3).ok


def _fixed_cap_case(a, b, D):
    jc, jcl, jv = jp.mesh_spgemm_fixed_cap(a, b, jp.make_row_mesh(D))
    tc, tcl, tv = tp.mesh_spgemm_fixed_cap(_port(a), _port(b), _tmesh(D))
    np.testing.assert_array_equal(tdist.fetch_output(tc), np.asarray(jc))
    got = tp.padded_to_host_csr(tc, tcl, tv, a.rows, b.cols)
    want = jdist.padded_to_host_csr(jc, jcl, jv, a.rows, b.cols)
    np.testing.assert_array_equal(got.row_offsets, want.row_offsets)
    np.testing.assert_array_equal(got.col_ids, want.col_ids)
    np.testing.assert_allclose(got.data, want.data, rtol=2e-3, atol=1e-5)
    r = compare_csr(oracle_spgemm(_port(a), _port(b)), got,
                    compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message
    return got


@pytest.mark.parametrize("shape", [(50, 50, 40, 0.12, 0.15),
                                   (37, 41, 23, 0.2, 0.2)],
                         ids=["fixed_cap", "uneven_rows"])
def test_mesh_spgemm_fixed_cap(rng, shape):
    m, k, n, da, db = shape
    a = random_host_csr(rng, m, k, da)
    b = random_host_csr(rng, k, n, db)
    _fixed_cap_case(a, b, 8)


def test_mesh_spgemm_fixed_cap_empty():
    a = JHostCSR(6, 6, np.zeros(7, np.uint32), np.zeros(0, np.uint32),
                 np.zeros(0))
    assert _fixed_cap_case(a, a, 4).nnz == 0


# ---------------------------------------------------------------------------
# multihost.py (one process)
# ---------------------------------------------------------------------------


def test_multihost_helpers_single_process():
    mesh = tmh.global_row_mesh(devices=["cpu"])
    assert mesh.size >= 1 and mesh.local == tuple(range(mesh.size))
    assert tmh.local_row_range(100) == (0, 100)
    assert tmh.scaling_efficiency(8.0, 1.25, 8) == 0.8
    tmh.initialize()   # one process: no process group, nothing to do
    assert tdist.process_count() == 1


@pytest.mark.parametrize("cards, local, want", [
    (0, None, "gloo"), (0, "4", "gloo"), (1, "1", "nccl"), (4, "4", "nccl"),
    (1, "2", "ValueError"), (4, None, "ValueError")])
def test_multihost_default_backend(monkeypatch, cards, local, want):
    """gloo without cards; NCCL when each of the node's processes
    (LOCAL_WORLD_SIZE) has a card of its own, as on two nodes of one card
    each; no quiet fall back to gloo with cards present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want == "ValueError":
        with pytest.raises(ValueError, match="backend="):
            tmh._default_backend(local)
    else:
        assert tmh._default_backend(local) == want


# ---------------------------------------------------------------------------
# the stream mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exchange", ["allgather", "needset"])
def test_mesh_stream_powerlaw(exchange):
    a = _powerlaw()
    _, to = _both(a, a, 8, exchange)
    if exchange == "needset":
        st = to[3]["stats"]
        assert st.reduction > 0
        assert st.pairs_nnz.sum() <= a.nnz * 8


def test_multihost_spgemm_single_process():
    """One process: multihost_spgemm is mesh_stream_spgemm over the local
    mesh (the powerlaw needset case's plan, so JAX's step is reused)."""
    a = _powerlaw()
    jo = jp.mesh_stream_spgemm(a, a, jp.make_row_mesh(8),
                               exchange="needset")
    to = tmh.multihost_spgemm(_port(a), _port(a), exchange="needset",
                              mesh=_tmesh(8))
    _check_out(jo, to, 8, np.float32)


@pytest.mark.parametrize("inp", ["global", "rowshards"])
def test_mesh_stream_presharded_inputs(rng, inp):
    """RowShards inputs with a k-split row in play: the same plan as the
    whole-matrix entry's reference run."""
    lil = sp.random(60, 60, 0.08, format="csr",
                    random_state=np.random.RandomState(5)).tolil()
    lil[7, :] = np.asarray(rng.standard_normal(60))
    a = JHostCSR.from_scipy(lil.tocsr())
    cfg = dict(stream_width=64, product_budget=1 << 14,
               mesh_split_min_ops=100)
    _, to = _both(a, a, 8, "needset", cfg, presharded=(inp == "rowshards"))
    assert to[3]["ksplit"] is not None


def _scattered():
    """A random 300 x 300 whose need-set pairs are all non-empty (shared
    by the two planner tests, so JAX reuses the default plan's step)."""
    return random_host_csr(np.random.default_rng(300), 300, 300, 0.02)


def test_needset_device_plan_matches_host_plan():
    a = _scattered()
    stats = {}
    for devplan in (True, False):
        _, to = _both(a, a, 8, "needset",
                      dict(mesh_device_planning=devplan))
        stats[devplan] = to[3]["stats"]
    np.testing.assert_array_equal(stats[True].pairs_nnz,
                                  stats[False].pairs_nnz)
    assert stats[True].needset_bytes == stats[False].needset_bytes
    offdiag = stats[True].pairs_nnz.sum() - np.trace(stats[True].pairs_nnz)
    assert offdiag > 0 and stats[True].needset_bytes > 0


def test_needset_exact_round_padding():
    a = _scattered()
    stats = {}
    for exact in (True, False):
        # exact padding under the default config (it moves less than
        # all_gather); pow2 padding with the fallback off
        kw = {} if exact else dict(mesh_round_pad_exact=False,
                                   mesh_exchange_auto=False)
        _, to = _both(a, a, 8, "needset", kw)
        stats[exact] = to[3]["stats"]
    assert stats[True].mode == stats[False].mode == "needset"
    assert stats[True].needset_bytes < stats[False].needset_bytes


def test_mesh_stream_needset_block_structure(rng):
    D, blk = 8, 48
    blocks = []
    for d in range(D):
        bmat = sp.random(blk, blk, 0.2, format="csr",
                         random_state=np.random.RandomState(d + 1))
        bmat.data = rng.standard_normal(bmat.nnz) + 1.0
        blocks.append(bmat)
    a = JHostCSR.from_scipy(sp.block_diag(blocks, format="csr"))
    _, to = _both(a, a, 8, "needset")
    st = to[3]["stats"]
    assert st.pairs_nnz.sum() - np.trace(st.pairs_nnz) == 0
    assert st.zero_comm and st.needset_bytes == 0


def test_mesh_stream_rectangular(rng):
    a = random_host_csr(rng, 70, 50, 0.15)
    b = random_host_csr(rng, 50, 90, 0.15)
    _both(a, b, 4, "needset")


@pytest.mark.parametrize("exchange", ["allgather", "needset"])
def test_mesh_stream_wide_row_ladder(monkeypatch, exchange):
    """One row of ~40x the chunk width: W stays at the configured width
    and the per-shard merge ladder finishes the row (its levels counted)."""
    levels = []
    level = tms.stream_level
    monkeypatch.setattr(tms, "stream_level",
                        lambda *a, **k: levels.append(1) or level(*a, **k))
    a = _with_rows(200, 0.05, 31, rows_full=(3,))
    _, to = _both(a, a, 8, exchange,
                  dict(stream_width=64, product_budget=1 << 14,
                       mesh_split_min_ops=1 << 30))
    assert to[3]["ksplit"] is None and levels


@pytest.mark.parametrize("exchange", ["allgather", "needset"])
def test_mesh_stream_ksplit_small(exchange):
    a = _with_rows(**KSPLIT)
    _, to = _both(a, a, 8, exchange, KSPLIT_CFG)
    assert to[3]["ksplit"]["split_ids"] == [17, 100]


def test_mesh_balanced_row_partition(rng):
    a = _skewed(rng)
    D, W, min_q = 8, 8192, 8
    b_len = np.diff(np.asarray(a.row_offsets, np.int64))
    ops = tms._host_row_ops(_port(a), b_len)
    bal = tp.balanced_row_ranges(ops, D, min_q)
    assert bal == jp.balanced_row_ranges(ops, D, min_q)
    bal_tot = [tms.tight_total_host(ops[r0:r1], W, min_q)
               for r0, r1 in bal]
    assert max(bal_tot) / max(min(bal_tot), 1) <= 1.5, bal_tot
    _, to = _both(a, a, 8, "needset")
    assert [tuple(r) for r in to[3]["ranges"]] == bal


@pytest.mark.parametrize("exchange", ["allgather", "needset"])
def test_mesh_stream_fp64(x64, exchange):
    a = _with_rows(160, 0.06, 44, rows_full=(9,))
    _, to = _both(a, a, 8, exchange,
                  dict(stream_width=64, product_budget=1 << 14,
                       mesh_split_min_ops=300), np_dtype=np.float64)
    assert to[3]["ksplit"] is not None


def _no_nonzero_b(case):
    """Queue 3 item 7's inputs: an 8 x 8 matrix with no nonzeros (A = B),
    and a 32 x 16 random A times a 16 x 24 B with no nonzeros."""
    if case == "empty_8x8":
        e = JHostCSR.from_scipy(sp.csr_matrix((8, 8)))
        return e, e
    rs = np.random.RandomState(5)
    a = sp.random(32, 16, 0.2, format="csr", random_state=rs)
    return (JHostCSR.from_scipy(a),
            JHostCSR.from_scipy(sp.csr_matrix((16, 24))))


@pytest.mark.parametrize("exchange", ["needset", "needset_overlap"])
@pytest.mark.parametrize("case", ["empty_8x8", "empty_b_32x16x24"])
def test_mesh_stream_fp64_b_without_nonzeros(x64, case, exchange):
    """float64 need-set exchanges of a B with no nonzeros: the received
    payload has no rows, and its value plane still views as float64."""
    a, b = _no_nonzero_b(case)
    _, to = _both(a, b, 4, exchange, np_dtype=np.float64)
    assert int(tdist.fetch_output(to[0]).sum()) == 0


def test_mesh_ksplit_caps_at_64_rows():
    rs = np.random.RandomState(51)
    base = sp.random(240, 240, 0.05, format="csr", random_state=rs)
    base.data = rs.standard_normal(base.nnz)
    lil = base.tolil()
    for r in range(0, 160, 2):              # 80 candidate rows
        lil[r, :] = rs.standard_normal(240)
    a = JHostCSR.from_scipy(lil.tocsr())
    _, to = _both(a, a, 8, "needset",
                  dict(stream_width=64, product_budget=1 << 18,
                       mesh_split_min_ops=500))
    assert to[3]["ksplit"]["n_split"] == 64


def test_mesh_ksplit_secondary_subrow_split():
    a = _with_rows(240, 0.08, 52, rows_full=(17,))
    _, to = _both(a, a, 8, "needset",
                  dict(KSPLIT_CFG, product_budget=1 << 16,
                       mesh_subrow_max_ops=300))
    assert to[3]["ksplit"]["max_parts"] > 1


@pytest.mark.parametrize("exchange", ["allgather", "needset"])
def test_mesh_two_phase_staging_budget(monkeypatch, exchange):
    """FusedStagingBudget=0: contained chunks count only and re-expand
    into C at emission, beside the chunks staged for the ladder. W = 256
    leaves chunks past the wide rows' rectangle rows (at the reference
    test's W = 64 every chunk holds wide segments and none re-expands);
    the re-expansion is counted."""
    calls = []
    numeric = tms.stream_chunk_numeric
    monkeypatch.setattr(tms, "stream_chunk_numeric",
                        lambda *a, **k: calls.append(1) or numeric(*a, **k))
    a = _with_rows(200, 0.06, 61, rows_full=(7,))
    _, to = _both(a, a, 8, exchange,
                  dict(stream_width=256, product_budget=1 << 12,
                       mesh_split_min_ops=1 << 30, fused_staging_budget=0))
    assert len(calls) == 8          # one re-expanded chunk a shard
    assert to[3]["ksplit"] is None


def test_mesh_needset_autofallback_to_allgather(rng):
    a = random_host_csr(rng, 96, 96, 0.5)
    _, to = _both(a, a, 8, "needset", dict(mesh_round_pad_exact=False))
    st = to[3]["stats"]
    assert st.needset_bytes > st.allgather_bytes
    assert st.mode == "allgather(auto)"
    _, to = _both(a, a, 8, "needset", dict(mesh_exchange_auto=False,
                                           mesh_round_pad_exact=False))
    assert to[3]["stats"].mode == "needset"
    _, to = _both(a, a, 8, "needset")
    assert to[3]["stats"].mode == "needset"
    assert to[3]["stats"].needset_bytes < to[3]["stats"].allgather_bytes


def test_mesh_step_reuse(rng):
    """A second multiply of the same static signature reuses the step
    object, in each package, and lands oracle-exact on it with new
    values."""
    a = random_host_csr(rng, 200, 200, 0.05)
    a2 = JHostCSR(rows=a.rows, cols=a.cols, row_offsets=a.row_offsets,
                  col_ids=a.col_ids,
                  data=np.asarray(rng.standard_normal(a.nnz), np.float32))
    jo1, to1 = _both(a, a, 8, "needset")
    fn_j, fn_t = jms.last_exec()[0], tms.last_exec()[0]
    jo2, to2 = _both(a2, a2, 8, "needset")
    assert jo2[3]["compiled_reused"] is True
    assert to2[3]["compiled_reused"] is True
    assert jms.last_exec()[0] is fn_j and tms.last_exec()[0] is fn_t
    # the cached step re-run on its arguments gives the same output
    fn, args = tms.last_exec()
    again = fn(*args)
    for x, y in zip(again, to2[:3]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_dryrun_multichip(capsys):
    """The dryrun's numbers of the reference's record on 8 shards:
    need-set 1192 against all_gather 1536 bytes, the block-diagonal
    product 0 against 2432 (zero communication), the dense route and the
    overlapped exchange, k-split n_split=2, in the reference's summary
    line word for word; and on each of its products (``dryrun_inputs``, the reference dryrun's
    seeds) the reference's own mesh gives the same meta (need-set stats
    and k-split among them) and the same C."""
    line = dryrun_multichip(8, devices=["cpu"])
    assert capsys.readouterr().out.strip() == line
    assert line == (
        "dryrun_multichip(8): OK, nnz(C)=964, needset bytes 1192 vs "
        "allgather 1536; block-diag needset 0 vs 2432 (ZERO-COMM); dense "
        "route OK; overlap OK; k-split engaged (n_split=2)")
    for step, (a, b, cfg, exchange) in dryrun_inputs(8).items():
        kw = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(TConfig)
              if cfg is not None and getattr(cfg, f.name) != f.default}
        jo = jp.mesh_stream_spgemm(_jax(a), _jax(b), jp.make_row_mesh(8),
                                   JConfig(**kw), exchange=exchange)
        to = tp.mesh_stream_spgemm(a, b, _tmesh(8), cfg, exchange=exchange)
        _check_out(jo, to, 8, np.float32)
        st = to[3]["stats"]
        if step == "needset":
            assert (st.needset_bytes, st.allgather_bytes) == (1192, 1536)
        elif step == "block-diagonal":
            assert (st.needset_bytes, st.allgather_bytes) == (0, 2432)
        elif step == "k-split":
            assert to[3]["ksplit"]["n_split"] == 2
        elif step == "dense":
            assert to[3]["route"] == "dense"
