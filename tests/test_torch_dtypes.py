"""Value types of speck_tpu_torch against speck_tpu: the 16 pairs of
{float16, bfloat16, float32, float64} for (A, B) through ``spgemm`` on a
stream input and on a banded one (the diagonal-plane route), ``esc_fixed``
and the mesh in bfloat16, and ``spgemm_scipy``.

For every pair the port gives the reference's output type, plan fields
and structure, or raises (TypeError) where the reference raises. Values:
float32 output within rel_tol 2e-3 and float64 within 1e-9 of the scipy
oracle of the inputs as rounded to their types; a 16-bit output within
``compare_csr_bound``: |C - C_ref| <= 2 (n_ij + 1) (u (|A| |B|)_ij + eta),
u = 2^-8 (bfloat16) or 2^-11 (float16), eta half the type's smallest
subnormal. Pairs with float64 run the reference under jax_enable_x64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speck_tpu as st
import speck_tpu_torch as pt
from speck_tpu_torch.utils.compare import compare_csr_bound
from speck_tpu_torch.utils.generators import make_banded, make_powerlaw

TYPES = {"f16": (torch.float16, jnp.float16),
         "bf16": (torch.bfloat16, jnp.bfloat16),
         "f32": (torch.float32, jnp.float32),
         "f64": (torch.float64, jnp.float64)}
PAIRS = [(a, b) for a in TYPES for b in TYPES]
_BASE = dict(enable_dense=False, enable_dia=False, enable_sdia=False,
             dia_rows=False)
# wide rows at W = 64 (merge levels and the finish)
_WIDE = dict(_BASE, stream_width=64, product_budget=1 << 11)
INPUTS = {
    # one chunk at W = 256, every row contained (few reference compiles)
    "stream": (lambda: make_powerlaw(400, avg=5, seed=3),
               dict(_BASE, stream_width=256, product_budget=1 << 13)),
    # the contiguous diagonal-plane route under the default config
    "banded": (lambda: make_banded(200, 3, seed=1), {}),
}


def _ref_host(h):
    return st.HostCSR.from_scipy(h.to_scipy())


def rounded(h, dtype):
    """``h`` with its values rounded to ``dtype`` (as float64)."""
    return pt.HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                      col_ids=h.col_ids, data=torch.as_tensor(
                          np.asarray(h.data)).to(dtype).double().numpy())


def check_values(ha, hb, C, dtype):
    """C (a HostCSR of ``dtype`` values) against the oracle of the rounded
    inputs ``ha`` and ``hb``, at the tolerance of its type."""
    if dtype in (torch.float16, torch.bfloat16):
        r = compare_csr_bound(ha, hb, C, dtype)
    else:
        r = pt.compare_csr(pt.oracle_spgemm(ha, hb), C, compare_data=True,
                           rel_tol=2e-3 if dtype == torch.float32 else 1e-9)
    assert r.ok, r.message


def _run_ref(h, ja, jb, kw):
    """(plan, C) of the reference, or the exception it raised."""
    x64 = jnp.float64 in (ja, jb)
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", x64)
    try:
        hj = _ref_host(h)
        A, B = st.device_put_csr(hj, ja), st.device_put_csr(hj, jb)
        p = st.plan_spgemm(A, B, st.SpgemmConfig(**kw))
        C = p.execute()
        return p, str(C.data.dtype), st.device_get_csr(C)
    except Exception as e:  # the reference's raise, to be matched
        return e, None, None
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def inputs():
    return {k: make() for k, (make, _) in INPUTS.items()}


@pytest.mark.parametrize("case", list(INPUTS))
@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_value_types_match_the_reference(inputs, case, pair):
    _check_pair(inputs[case], INPUTS[case][1], case, pair)


@pytest.mark.parametrize("pair", [("bf16", "bf16"), ("f16", "f16"),
                                  ("bf16", "f32")],
                         ids=lambda p: "-".join(p))
def test_wide_rows_match_the_reference(inputs, pair):
    """Wide rows at W = 64 (merge levels and the finish, K1 at per-row
    rids) in 16 bits and mixed."""
    _check_pair(inputs["stream"], _WIDE, "wide", pair)


def _check_pair(h, kw, case, pair):
    (ta, ja), (tb, jb) = TYPES[pair[0]], TYPES[pair[1]]
    pj, jdt, Cj = _run_ref(h, ja, jb, kw)
    A = pt.device_put_csr(h, ta, device="cpu")
    B = pt.device_put_csr(h, tb, device="cpu")
    if isinstance(pj, Exception):
        with pytest.raises(TypeError):
            pt.spgemm(A, B, pt.SpgemmConfig(**kw))
        return
    plan = pt.plan_spgemm(A, B, pt.SpgemmConfig(**kw))
    C = plan.execute()
    assert str(C.data.dtype).replace("torch.", "") == jdt
    if case == "banded":
        assert plan.dia is not None and pj.dia is not None
        for f in ("span_a", "span_b", "span_c", "dmin_a", "dmin_b",
                  "uniform"):
            assert getattr(plan.dia, f) == getattr(pj.dia, f), f
    else:
        lo, loj = plan.stream.layout, pj.stream.layout
        for f in ("W", "G", "g_last", "n_chunks", "total_q", "n_wide",
                  "r_wide", "n_stream_rows", "n_direct_rows"):
            assert getattr(lo, f) == getattr(loj, f), f
        assert plan.stream.pack_bits == pj.stream.pack_bits
        assert (lo.n_wide > 0) == (case == "wide")
    Ct = pt.device_get_csr(C)
    np.testing.assert_array_equal(np.asarray(Ct.row_offsets, np.int64),
                                  np.asarray(Cj.row_offsets, np.int64))
    np.testing.assert_array_equal(np.asarray(Ct.col_ids, np.int64),
                                  np.asarray(Cj.col_ids, np.int64))
    check_values(rounded(h, ta), rounded(h, tb), Ct, C.data.dtype)


@pytest.mark.parametrize("pair", [("bf16", "bf16"), ("bf16", "f32")])
def test_esc_fixed_in_16_bits(pair):
    """esc_fixed (K3 and K2 by slot) in bfloat16 and mixed: the
    reference's output type and structure, values within the bound."""
    from speck_tpu.ops.esc import esc_fixed as esc_j
    from speck_tpu_torch.ops.esc import esc_fixed as esc_t
    from speck_tpu_torch.parallel import padded_to_host_csr

    h = make_banded(160, 4, seed=5)
    (ta, ja), (tb, jb) = TYPES[pair[0]], TYPES[pair[1]]
    ip = np.asarray(h.row_offsets, np.int32)
    cx = np.asarray(h.col_ids, np.int32)
    args_j = (jnp.asarray(ip), jnp.asarray(cx),
              jnp.asarray(h.data).astype(ja), jnp.asarray(ip[:-1]),
              jnp.asarray(np.diff(ip)), jnp.asarray(cx),
              jnp.asarray(h.data).astype(jb))
    cj, colj, vj = esc_j(*args_j, cap=128, n_cols=h.cols)
    d = torch.as_tensor(np.asarray(h.data))
    ct, colt, vt = esc_t(torch.as_tensor(ip), torch.as_tensor(cx), d.to(ta),
                         torch.as_tensor(ip[:-1]),
                         torch.as_tensor(np.diff(ip)), torch.as_tensor(cx),
                         d.to(tb), cap=128, n_cols=h.cols)
    assert str(vt.dtype).replace("torch.", "") == str(vj.dtype)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    C = padded_to_host_csr(ct, colt, vt, h.rows, h.cols)
    Cj = padded_to_host_csr(np.asarray(cj), np.asarray(colj),
                            np.asarray(vj, np.float32), h.rows, h.cols)
    np.testing.assert_array_equal(C.col_ids, Cj.col_ids)
    check_values(rounded(h, ta), rounded(h, tb), C, vt.dtype)


@pytest.mark.parametrize("case", ["sdia", "dense", "stream"])
def test_mesh_in_bfloat16(case):
    """The mesh in bfloat16 on four CPU shards: its diagonal-plane route
    (a band under needset) and its dense route (allgather, sdia off) run,
    with the reference's route, output type and structure; its stream
    route raises, as the reference's does (it packs B's values as 32-bit
    words)."""
    from speck_tpu.parallel import make_row_mesh as mesh_j
    from speck_tpu.parallel import mesh_stream_spgemm as run_j
    from speck_tpu.parallel.mesh_stream import mesh_stream_to_host_csr as h_j
    from speck_tpu_torch.parallel import (make_row_mesh,
                                          mesh_stream_spgemm,
                                          mesh_stream_to_host_csr)

    h = (make_powerlaw(400, avg=5, seed=3) if case == "stream"
         else make_banded(256, 3, seed=1))
    kw = dict(enable_sdia=False) if case == "dense" else {}
    ex = "allgather" if case == "dense" else "needset"
    mesh = make_row_mesh(4, devices=["cpu"])
    if case == "stream":
        with pytest.raises(ValueError):
            run_j(_ref_host(h), _ref_host(h), mesh_j(4), st.SpgemmConfig(),
                  exchange=ex, dtype=jnp.bfloat16)
        with pytest.raises(TypeError):
            mesh_stream_spgemm(h, h, mesh, pt.SpgemmConfig(), exchange=ex,
                               dtype=torch.bfloat16)
        return
    oj = run_j(_ref_host(h), _ref_host(h), mesh_j(4), st.SpgemmConfig(**kw),
               exchange=ex, dtype=jnp.bfloat16)
    ot = mesh_stream_spgemm(h, h, mesh, pt.SpgemmConfig(**kw), exchange=ex,
                            dtype=torch.bfloat16)
    assert ot[3]["route"] == oj[3]["route"] == case
    assert ot[2].dtype == torch.bfloat16 and str(oj[2].dtype) == "bfloat16"
    C, Cj = mesh_stream_to_host_csr(*ot), h_j(*oj)
    np.testing.assert_array_equal(C.row_offsets, Cj.row_offsets)
    np.testing.assert_array_equal(C.col_ids, Cj.col_ids)
    hb = rounded(h, torch.bfloat16)
    check_values(hb, hb, C, torch.bfloat16)


@pytest.mark.parametrize("dtype", [None, np.float64])
def test_spgemm_scipy_matches_the_reference(dtype):
    """spgemm_scipy on the CPU: the reference's matrix (float32 by
    default), structure equal, values at the type's tolerance."""
    h = make_powerlaw(300, avg=4, seed=9)
    a = h.to_scipy()
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", dtype is not None)
    try:
        cj = st.spgemm_scipy(a, a, dtype=dtype)
    finally:
        jax.config.update("jax_enable_x64", old)
    ct = pt.spgemm_scipy(a, a, dtype=dtype, device="cpu")
    assert ct.dtype == cj.dtype
    np.testing.assert_array_equal(ct.indptr, cj.indptr)
    np.testing.assert_array_equal(ct.indices, cj.indices)
    np.testing.assert_allclose(ct.data, cj.data,
                               rtol=1e-5 if dtype is None else 1e-12,
                               atol=1e-6)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if torch.cuda.is_available():
            raise RuntimeError('no card here: device="cpu"')
        pt.spgemm_scipy(a, a)


def _one_dense_row(n=160, seed=7):
    """160 rows at density 0.08 with row 0 dense: row 0 takes the
    accumulator under ``enable_accum=True``."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    lil = sp.random(n, n, 0.08, format="csr", random_state=rs).tolil()
    lil[0, :] = rs.standard_normal(n)
    mat = lil.tocsr()
    mat.data = rs.standard_normal(mat.nnz)
    return pt.HostCSR.from_scipy(mat)


C_PATHS = {
    "fused": {},
    "two_phase": dict(fused_staging_budget=0),
    "new_values": {},
    "accum": dict(enable_accum=True, accum_min_ops=512, stream_width=64,
                  product_budget=1 << 12),
}


@pytest.mark.parametrize("path", list(C_PATHS))
@pytest.mark.parametrize("pair", [("bf16", "f32"), ("f16", "f64")],
                         ids=lambda p: "-".join(p))
def test_c_type_is_the_fused_paths_on_every_path(pair, path):
    """A 16-bit A times a wider B: C takes the fused path's type (the
    promoted one) on the two-phase path, with new values
    (``execute(A, B)``) and through the accumulator too, with values
    within that type's gate against the oracle of the rounded inputs.
    The reference emits the first two in A's type and sums the third in
    A's type (ROADMAP Queue 3 item 8); the port repairs them."""
    (ta, _), (tb, _) = TYPES[pair[0]], TYPES[pair[1]]
    h = _one_dense_row() if path == "accum" else make_powerlaw(300, seed=3)
    A = pt.device_put_csr(h, ta, device="cpu")
    B = pt.device_put_csr(h, tb, device="cpu")
    kw = dict(_BASE, **C_PATHS[path])
    fused = pt.plan_spgemm(A, B, pt.SpgemmConfig(**_BASE)).execute()
    plan = pt.plan_spgemm(A, B, pt.SpgemmConfig(**kw))
    C = plan.execute(A, B) if path == "new_values" else plan.execute()
    assert plan.stream.fused == (path != "two_phase")
    assert (plan.stream.n_accum > 0) == (path == "accum")
    assert fused.data.dtype == torch.promote_types(ta, tb)
    assert C.data.dtype == fused.data.dtype
    check_values(rounded(h, ta), rounded(h, tb), pt.device_get_csr(C),
                 C.data.dtype)
