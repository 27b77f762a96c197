"""speck_tpu_torch.spgemm against speck_tpu.spgemm and the scipy oracle.

The same seeded matrices and configuration go through both packages:
row_offsets and col_ids must be equal, values within rtol 1e-5 of JAX
(fp32 duplicate sums may be taken in another order), and the port must
pass compare_csr against the float64 oracle at rel_tol 2e-3 (the JAX
stream tests' own bar). Both sides disable the DIA and dense routes,
which the small matrices would otherwise take."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import speck_tpu as st
import speck_tpu_torch as pt

_BASE = dict(enable_dense=False, enable_dia=False, enable_sdia=False,
             dia_rows=False)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _powerlaw(m=1500, avg=6, alpha=2.2, seed=23):
    rs = np.random.RandomState(seed)
    lens = np.minimum((rs.pareto(alpha, m) + 1) * avg * 0.5, m // 4
                      ).astype(np.int64)
    rows = np.repeat(np.arange(m), lens)
    mat = sp.csr_matrix((rs.standard_normal(rows.shape[0]),
                         (rows, rs.randint(0, m, rows.shape[0]))),
                        shape=(m, m))
    mat.sum_duplicates()
    return st.HostCSR.from_scipy(mat)


def _wide(n=160, seed=7):
    """Random 160x160 at density 0.08 plus one dense row (wide at W=64)."""
    rs = np.random.RandomState(seed)
    lil = sp.random(n, n, 0.08, format="csr", random_state=rs).tolil()
    lil[0, :] = rs.standard_normal(n)
    mat = lil.tocsr()
    mat.data = rs.standard_normal(mat.nnz)
    return st.HostCSR.from_scipy(mat)


def _direct(m=120, seed=3):
    """Single-nonzero rows (direct copies), general rows and empty rows."""
    rs = np.random.RandomState(seed)
    rows, cols = [], []
    for r in range(m):
        if r % 7 == 3:
            continue
        k = 1 if r % 2 == 0 else int(rs.randint(2, 9))
        rows += [r] * k
        cols += list(rs.choice(m, k, replace=False))
    mat = sp.csr_matrix((rs.standard_normal(len(rows)), (rows, cols)),
                        shape=(m, m))
    return st.HostCSR.from_scipy(mat)


SLICE_CASES = {
    "powerlaw": (_powerlaw, dict(stream_width=256, product_budget=1 << 13)),
    "wide": (_wide, dict(stream_width=64, product_budget=1 << 10)),
    "two_phase": (_wide, dict(stream_width=64, product_budget=1 << 10,
                              fused_staging_budget=0)),
    # a tiny stream_max_width forces the merge-level ladder
    "ladder": (_wide, dict(stream_width=64, product_budget=1 << 10,
                           stream_max_width=64)),
    "direct": (_direct, dict(stream_width=64, product_budget=1 << 10)),
}


def _run_both(h, kw, execute_new=False):
    cj = st.SpgemmConfig(**dict(_BASE, **kw))
    ct = pt.SpgemmConfig(**dict(_BASE, **kw))
    Aj = st.device_put_csr(h)
    At = pt.device_put_csr(pt.HostCSR.from_host(h), device="cpu")
    pj = st.plan_spgemm(Aj, Aj, cj)
    ptp = pt.plan_spgemm(At, At, ct)
    if not execute_new:
        return h, st.device_get_csr(pj.execute()), \
            pt.device_get_csr(ptp.execute()), ptp
    h2 = st.HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                    col_ids=h.col_ids, data=h.data * 2.0 + 0.25)
    Aj2 = st.device_put_csr(h2)
    At2 = pt.device_put_csr(pt.HostCSR.from_host(h2), device="cpu")
    return h2, st.device_get_csr(pj.execute(Aj2, Aj2)), \
        pt.device_get_csr(ptp.execute(At2, At2)), ptp


def _assert_matches(h, Cj, Ct):
    np.testing.assert_array_equal(np.asarray(Ct.row_offsets, np.int64),
                                  np.asarray(Cj.row_offsets, np.int64))
    np.testing.assert_array_equal(np.asarray(Ct.col_ids, np.int64),
                                  np.asarray(Cj.col_ids, np.int64))
    np.testing.assert_allclose(Ct.data, Cj.data, rtol=1e-5, atol=1e-6)
    hp = pt.HostCSR.from_host(h)
    r = pt.compare_csr(pt.oracle_spgemm(hp, hp), Ct, compare_data=True,
                       rel_tol=2e-3)
    assert r.ok, r.message


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_spgemm_matches_jax_and_oracle(case):
    make, kw = SLICE_CASES[case]
    h, Cj, Ct, plan = _run_both(make(), kw)
    _assert_matches(h, Cj, Ct)
    lo = plan.stream.layout
    if case in ("wide", "two_phase", "ladder"):
        assert lo.n_wide > 0
    if case == "ladder":
        assert plan.stream.finish["classes"] is None
    if case == "two_phase":
        assert not plan.stream.fused
    if case == "direct":
        assert plan.groups and lo.n_direct_rows > 0


@pytest.mark.parametrize("case", ["wide", "two_phase"])
def test_plan_execute_with_new_values(case):
    make, kw = SLICE_CASES[case]
    h2, Cj, Ct, _ = _run_both(make(), kw, execute_new=True)
    _assert_matches(h2, Cj, Ct)


def test_spgemm_entry_point_and_cli(tmp_path):
    """The public spgemm and the port's runspECK CLI on a .mtx file."""
    h = pt.HostCSR.from_host(_direct())
    cfg = pt.SpgemmConfig(**dict(_BASE, stream_width=64))
    A = pt.device_put_csr(h, device="cpu")
    C = pt.device_get_csr(pt.spgemm(A, A, cfg))
    assert pt.compare_csr(pt.oracle_spgemm(h, h), C, compare_data=True,
                          rel_tol=2e-3).ok
    from speck_tpu_torch.cli import main
    from speck_tpu_torch.formats.csr import HostCOO
    from speck_tpu_torch.formats.mtx import store_mtx

    coo = h.to_scipy().tocoo()
    path = str(tmp_path / "m.mtx")
    store_mtx(path, HostCOO(h.rows, h.cols, coo.row.astype(np.uint32),
                            coo.col.astype(np.uint32), coo.data))
    ini = tmp_path / "c.ini"
    ini.write_text("IterationsWarmUp=1\nIterationsExecution=1\n"
                   "CompareResult=true\nEnableDense=false\nEnableDia=false\n"
                   "EnableSdia=false\nDiaRows=false\n")
    assert main(["cli", path, str(ini)], device="cpu") == 0


@pytest.mark.parametrize("flag", [False, True], ids=["f32", "fp64"])
def test_cli_fp64(tmp_path, monkeypatch, flag):
    """``--fp64`` runs the CLI in float64 end to end (as runspeck's flag
    does): every call's C is float64 and within 1e-9 of scipy; without
    the flag the run stays float32."""
    from speck_tpu_torch import executor
    from speck_tpu_torch.cli import main
    from speck_tpu_torch.formats.csr import HostCOO
    from speck_tpu_torch.formats.mtx import store_mtx

    h = pt.HostCSR.from_host(_direct())
    coo = h.to_scipy().tocoo()
    path = str(tmp_path / "m.mtx")
    store_mtx(path, HostCOO(h.rows, h.cols, coo.row.astype(np.uint32),
                            coo.col.astype(np.uint32), coo.data))
    ini = tmp_path / "c.ini"
    ini.write_text("IterationsWarmUp=1\nIterationsExecution=1\n")
    outs = []

    def recording_spgemm(*args, **kw):
        outs.append(executor_spgemm(*args, **kw))
        return outs[-1]

    executor_spgemm = executor.spgemm
    monkeypatch.setattr(executor, "spgemm", recording_spgemm)
    argv = ["cli", path, str(ini)] + (["--fp64"] if flag else [])
    assert main(argv, device="cpu") == 0
    assert len(outs) == 2
    want = torch.float64 if flag else torch.float32
    ref = pt.oracle_spgemm(h, h)
    for C in outs:
        assert C.data.dtype == want
        r = pt.compare_csr(ref, pt.device_get_csr(C), compare_data=True,
                           rel_tol=1e-9 if flag else 2e-3)
        assert r.ok, r.message


def test_float64_raises():
    """float64 no longer raises: the direct-copy input streams in float64
    (the unpacked B gathers) with float64 values out, equal to JAX's under
    jax_enable_x64 within rtol 1e-12 and to the oracle within 1e-9.
    float16 runs as well (tests/test_torch_dtypes.py holds every type pair
    to the reference)."""
    import jax

    h = pt.HostCSR.from_host(_direct())
    A = pt.device_put_csr(h, np.float64, device="cpu")
    kw = dict(_BASE, stream_width=64, product_budget=1 << 10)
    Ct = pt.device_get_csr(pt.spgemm(A, A, pt.SpgemmConfig(**kw)))
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        Aj = st.device_put_csr(_direct(), np.float64)
        Cj = st.device_get_csr(st.spgemm(Aj, Aj, st.SpgemmConfig(**kw)))
    finally:
        jax.config.update("jax_enable_x64", old)
    assert Ct.data.dtype == np.float64
    np.testing.assert_array_equal(np.asarray(Ct.col_ids, np.int64),
                                  np.asarray(Cj.col_ids, np.int64))
    np.testing.assert_allclose(Ct.data, Cj.data, rtol=1e-12, atol=1e-13)
    r = pt.compare_csr(pt.oracle_spgemm(h, h), Ct, compare_data=True,
                       rel_tol=1e-9)
    assert r.ok, r.message
    # float16 runs too: float16 out, within the 16-bit bound of the
    # oracle of the rounded input
    from speck_tpu_torch.utils.compare import compare_csr_bound

    A16 = pt.DeviceCSR(indptr=A.indptr, indices=A.indices,
                       data=A.data.half(), shape=A.shape, nnz=A.nnz)
    C16 = pt.spgemm(A16, A16, pt.SpgemmConfig(**kw))
    assert C16.data.dtype == torch.float16
    h16 = pt.HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                     col_ids=h.col_ids, data=A16.data.double().numpy())
    r = compare_csr_bound(h16, h16, pt.device_get_csr(C16), torch.float16)
    assert r.ok, r.message


def test_banded_input_raises_where_dia_would_run():
    """A banded matrix passes the reference's DIA gate: the port takes the
    same route (it raised here before the DIA family was ported), with
    equal plan fields and output, under the default configuration."""
    n = 400
    mat = sp.diags([np.ones(n - abs(o)) for o in range(-3, 4)],
                   list(range(-3, 4)), shape=(n, n), format="csr")
    h = st.HostCSR.from_scipy(mat)
    Aj = st.device_put_csr(h)
    pj = st.plan_spgemm(Aj, Aj)
    assert pj.dia is not None   # the reference's route
    At = pt.device_put_csr(pt.HostCSR.from_host(h), device="cpu")
    ptp = pt.plan_spgemm(At, At)
    assert ptp.dia is not None and ptp.dia.off_a is None
    for f in ("span_a", "span_b", "span_c", "dmin_a", "dmin_b", "uniform"):
        assert getattr(ptp.dia, f) == getattr(pj.dia, f), f
    Cj = st.device_get_csr(pj.execute())
    Ct = pt.device_get_csr(pt.spgemm(At, At))
    _assert_matches(h, Cj, Ct)


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np, scipy.sparse as sp\n"
        "import speck_tpu_torch as pt\n"
        "m = sp.random(50, 50, 0.1, format='csr',"
        " random_state=np.random.RandomState(0))\n"
        "h = pt.HostCSR.from_scipy(m)\n"
        "A = pt.device_put_csr(h, device='cpu')\n"
        "cfg = pt.SpgemmConfig(enable_dense=False, enable_dia=False,"
        " enable_sdia=False, dia_rows=False)\n"
        "C = pt.device_get_csr(pt.spgemm(A, A, cfg))\n"
        "assert pt.compare_csr(pt.oracle_spgemm(h, h), C).ok\n"
        "from speck_tpu_torch.utils.generators import make_banded\n"
        "hb = make_banded(300, half_band=3, seed=1)\n"
        "B = pt.device_put_csr(hb, device='cpu')\n"
        "assert pt.plan_spgemm(B, B).dia is not None\n"
        "C = pt.device_get_csr(pt.spgemm(B, B))\n"
        "assert pt.compare_csr(pt.oracle_spgemm(hb, hb), C,"
        " compare_data=True, rel_tol=2e-3).ok\n"
        "import speck_tpu_torch.probes.expand_microbench\n"
        "import speck_tpu_torch.probes.gather_microbench2\n"
        "from speck_tpu_torch.entry import _example_matrices, entry\n"
        "from speck_tpu_torch.parallel import padded_to_host_csr\n"
        "fn, args = entry(device='cpu')\n"
        "a, b = _example_matrices()\n"
        "got = padded_to_host_csr(*fn(*args), a.rows, b.cols)\n"
        "assert pt.compare_csr(pt.oracle_spgemm(a, b), got).ok\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(k.startswith('speck_tpu.') or k == 'speck_tpu'"
        " for k in sys.modules)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("call", ["device_put_csr", "executor",
                                  "device_info", "cli", "entry"])
def test_entry_points_default_to_the_card(monkeypatch, call):
    """Without a device argument every entry point takes the card, and
    without one it raises, naming device="cpu"; it never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = pt.HostCSR.from_host(_direct())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if call == "device_put_csr":
            pt.device_put_csr(h)
        elif call == "executor":
            from speck_tpu_torch.executor import Executor
            Executor("unused.mtx")
        elif call == "device_info":
            pt.device_info()
        elif call == "cli":
            from speck_tpu_torch.cli import main
            main(["cli", "unused.mtx"])
        else:
            from speck_tpu_torch.entry import entry
            entry()


def test_no_card_raises_in_a_fresh_process():
    """With CUDA_VISIBLE_DEVICES="" the default device_put_csr and Executor
    raise the clear error instead of running on the CPU."""
    code = (
        "import numpy as np, scipy.sparse as sp\n"
        "import speck_tpu_torch as pt\n"
        "from speck_tpu_torch.executor import Executor\n"
        "h = pt.HostCSR.from_scipy(sp.random(9, 9, 0.3, format='csr',"
        " random_state=np.random.RandomState(0)))\n"
        "for f in (lambda: pt.device_put_csr(h),"
        " lambda: Executor('unused.mtx')):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        assert 'device=\"cpu\"' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('ran without a card')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
