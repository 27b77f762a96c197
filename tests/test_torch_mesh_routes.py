"""The row mesh's diagonal-plane, dense-window and overlapped need-set
routes of the port against speck_tpu's, on the CPU.

As ``tests/test_torch_mesh.py`` (whose helpers these are): the same seeded
inputs through ``speck_tpu.parallel`` on the conftest's 8-device CPU mesh
and through ``speck_tpu_torch.parallel`` with ``make_row_mesh(D,
devices=["cpu"])``; meta equal field by field (``route``, the stats' mode
and both byte counts, ``pairs_nnz``, ``m_loc``, ``out_cap``, ``ranges``,
``ksplit``), ``nnz_row`` and columns equal, values within rtol 2e-3 of
JAX's in float32 and 1e-12 in float64 (under ``jax_enable_x64``), and every
result within the oracle's tolerance. The cases are those of
``tests/test_parallel.py`` for these routes."""

import numpy as np
import pytest
import scipy.sparse as sp

import speck_tpu.parallel as jp
import speck_tpu_torch.parallel as tp
from conftest import random_host_csr
from speck_tpu.formats.csr import HostCSR as JHostCSR
from speck_tpu.parallel import mesh_stream as jms
from speck_tpu_torch.parallel import mesh_stream as tms
from speck_tpu_torch.utils.compare import compare_csr
from speck_tpu_torch.utils.oracle import oracle_spgemm

from test_torch_mesh import (KSPLIT, KSPLIT_CFG, _blockperm, _both,
                             _port, _powerlaw, _tmesh, _with_rows, x64)

assert x64  # the fixture, used by name below


def _banded(n=4096, half_band=8, seed=3):
    rs = np.random.RandomState(seed)
    offs = list(range(-half_band, half_band + 1))
    mat = sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                   shape=(n, n), format="csr")
    return JHostCSR.from_scipy(mat)


def _stencil27(g=16, seed=19):
    rs = np.random.RandomState(seed)
    n = g ** 3
    offs = sorted(dz * g * g + dy * g + dx
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1))
    mat = sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                   shape=(n, n), format="csr")
    return JHostCSR.from_scipy(mat)


# ---------------------------------------------------------------------------
# the diagonal-plane route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["banded", "stencil27"])
def test_mesh_dia_route(name):
    """Banded and 27-point stencil inputs take the diagonal-plane route
    with its ring halo: the halo bytes far below replication."""
    a = _banded() if name == "banded" else _stencil27()
    _, to = _both(a, a, 8, "needset")
    meta = to[3]
    assert meta["route"] == "sdia"
    st = meta["stats"]
    assert st.mode == "dia_halo"
    assert st.needset_bytes < st.allgather_bytes // 4


def test_mesh_dia_route_fp64(x64):
    a = _banded()
    _, to = _both(a, a, 8, "needset", np_dtype=np.float64)
    assert to[3]["route"] == "sdia"
    assert to[3]["stats"].mode == "dia_halo"


def test_mesh_dia_route_rejects_unbanded(rng):
    """An unstructured input fails the band gates and streams (under
    need-set the dense gate is not consulted)."""
    a = random_host_csr(rng, 128, 128, 0.05)
    _, to = _both(a, a, 8, "needset")
    assert to[3]["route"] == "stream"


# ---------------------------------------------------------------------------
# the dense-window route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile_rows", [256, 32])
def test_mesh_dense_route(tile_rows):
    """Block-permuted tile-bounded input under allgather: one tile a shard
    and K = 2; under need-set, or with the dense route off, the stream."""
    a = _blockperm()
    _, to = _both(a, a, 8, "allgather", dict(dense_tile_rows=tile_rows))
    assert to[3]["route"] == "dense"
    assert to[3]["stats"].mode == "dense_allgather"
    if tile_rows != 256:
        return
    _, to = _both(a, a, 8, "needset")
    assert to[3]["route"] == "stream"
    _, to = _both(a, a, 8, "allgather", dict(enable_dense=False))
    assert to[3]["route"] == "stream"


def test_mesh_dense_route_fp64(x64):
    a = _blockperm(m=256, blk=32, nnz_per_row=6, seed=29)
    _, to = _both(a, a, 8, "allgather", np_dtype=np.float64)
    assert to[3]["route"] == "dense"


def test_mesh_dense_route_rectangular(rng):
    a = random_host_csr(rng, 128, 96, 0.1)
    b = random_host_csr(rng, 96, 160, 0.1)
    _, to = _both(a, b, 8, "allgather")
    assert to[3]["route"] == "dense"


def test_mesh_dense_route_balanced_ragged_shards():
    """A work-skewed but tile-bounded input: ops-balanced (ragged) A
    shards, padded to the widest."""
    m, blk = 512, 64
    nb = m // blk
    rs = np.random.RandomState(77)
    lens = np.where(np.arange(m) < m // 4, 32, 4)
    rows = np.repeat(np.arange(m), lens)
    pd = (nb - 1 - (rows // blk)) * blk
    cols = pd + rs.randint(0, blk, rows.shape[0])
    mat = sp.csr_matrix(
        (rs.standard_normal(rows.shape[0]), (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    a = JHostCSR.from_scipy(mat)
    _, to = _both(a, a, 8, "allgather")
    assert to[3]["route"] == "dense"
    assert len({r1 - r0 for r0, r1 in to[3]["ranges"]}) > 1


def test_mesh_dense_route_rejects_wide_rows():
    """One row past dense_la sends the whole product to the stream."""
    a = _blockperm()
    lil = sp.csr_matrix((a.data, a.col_ids, a.row_offsets),
                        shape=a.shape).tolil()
    lil[5, :200] = np.random.RandomState(7).standard_normal(200)
    a2 = JHostCSR.from_scipy(lil.tocsr())
    _, to = _both(a2, a2, 8, "allgather")
    assert to[3]["route"] == "stream"


def test_mesh_dense_step_reuse():
    """Two different block-permuted matrices share one static signature:
    the second rides the first's cached step in each package and stays
    oracle-exact."""
    b1, b2 = _blockperm(seed=101), _blockperm(seed=202)
    _, to1 = _both(b1, b1, 8, "allgather")
    assert to1[3]["route"] == "dense"
    fn_j, fn_t = jms.last_exec()[0], tms.last_exec()[0]
    jo2, to2 = _both(b2, b2, 8, "allgather")
    assert to2[3]["route"] == "dense"
    assert jo2[3]["compiled_reused"] is True
    assert to2[3]["compiled_reused"] is True
    assert jms.last_exec()[0] is fn_j and tms.last_exec()[0] is fn_t
    r = compare_csr(oracle_spgemm(_port(b2), _port(b2)),
                    tp.mesh_stream_to_host_csr(*to2), compare_data=True,
                    rel_tol=2e-3)
    assert r.ok, r.message


# ---------------------------------------------------------------------------
# the overlapped need-set exchange
# ---------------------------------------------------------------------------


def test_mesh_stream_powerlaw_overlap():
    a = _powerlaw()
    _, to = _both(a, a, 8, "needset_overlap")
    st = to[3]["stats"]
    assert st.mode == "needset_overlap"
    assert st.needset_bytes < st.allgather_bytes


def test_mesh_stream_wide_row_ladder_overlap(monkeypatch):
    levels = []
    level = tms.stream_level
    monkeypatch.setattr(tms, "stream_level",
                        lambda *a, **k: levels.append(1) or level(*a, **k))
    a = _with_rows(200, 0.05, 31, rows_full=(3,))
    _, to = _both(a, a, 8, "needset_overlap",
                  dict(stream_width=64, product_budget=1 << 14,
                       mesh_split_min_ops=1 << 30))
    assert to[3]["ksplit"] is None and levels


def test_mesh_stream_ksplit_small_overlap():
    a = _with_rows(**KSPLIT)
    _, to = _both(a, a, 8, "needset_overlap", KSPLIT_CFG)
    assert to[3]["ksplit"]["split_ids"] == [17, 100]


def test_mesh_stream_fp64_overlap(x64):
    a = _with_rows(160, 0.06, 44, rows_full=(9,))
    _, to = _both(a, a, 8, "needset_overlap",
                  dict(stream_width=64, product_budget=1 << 14,
                       mesh_split_min_ops=300), np_dtype=np.float64)
    assert to[3]["ksplit"] is not None


def test_overlap_groups_and_waits(monkeypatch):
    """The overlapped step splits the rows over several live rounds, sends
    every payload round before any group runs, and each group waits only
    for the rounds up to its own."""
    events = []
    start = tms.ppermute_start

    def tracking_start(mesh, parts, shift):
        events.append(("send", shift))
        rnd = start(mesh, parts, shift)
        wait = rnd.wait

        def tracked(d):
            if d == 0:
                events.append(("wait", shift))
            return wait(d)
        rnd.wait = tracked
        return rnd

    pipeline = tms._stream_pipeline

    def tracking_pipeline(*a, **k):
        if k.get("row_mask") is not None:
            events.append(("group", None))
        return pipeline(*a, **k)

    monkeypatch.setattr(tms, "ppermute_start", tracking_start)
    monkeypatch.setattr(tms, "_stream_pipeline", tracking_pipeline)
    a = _powerlaw()
    _, to = _both(a, a, 8, "needset_overlap")
    step = tms.last_exec()[0]
    rounds = [g["round"] for g in step.body.groups]
    assert len(rounds) > 1 and rounds == sorted(rounds)
    sent = [r for k, r in events if k == "send"]
    assert len(sent) > 1
    # every round is sent first; then shard 0 runs its groups in order,
    # each after waiting for the rounds up to its own and no later one
    want = [("send", r) for r in sent]
    prev = -1
    for r in rounds:
        want += [("wait", pr) for pr in sent if prev < pr <= r]
        want.append(("group", None))
        prev = r
    assert events[: len(want)] == want
