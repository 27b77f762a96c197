"""The port's fixed-cap ESC (ops/esc.py, ops/contract.py contract_runs, the
entry) against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both packages.
Tolerances: the contract's plain version is bit-identical to the JAX forms
(the Pallas kernel in interpret mode and the XLA doubling: same order);
the owner fill is exact; ``_expand``'s columns and counts are exact and
its values within rtol 1e-6 (one float32 product each); ``esc_fixed``'s
counts and columns are exact in every slot and its values within rtol 1e-5
/ atol 1e-6 inside the counts (duplicate columns may be summed in another
order), and each result is within rel_tol 2e-3 of the scipy oracle (the
JAX stream tests' bar)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import __graft_entry__ as graft
from speck_tpu.ops import esc as jesc
from speck_tpu.ops.pallas_kernels import contract_runs as j_contract_runs
import speck_tpu_torch as pt
from speck_tpu_torch import entry as tentry
from speck_tpu_torch.ops import contract
from speck_tpu_torch.ops import esc as tesc
from speck_tpu_torch.parallel import padded_to_host_csr

N_COLS = 300


def _sorted_cols(rng, R, W):
    """Column-sorted rows with duplicate runs and sentinel tails."""
    col = np.full((R, W), N_COLS, np.int32)
    for r in range(R):
        live = int(rng.integers(0, W + 1))
        col[r, :live] = np.sort(rng.integers(0, N_COLS, live))
    return col, rng.standard_normal((R, W)).astype(np.float32)


@pytest.mark.parametrize("R,W", [(64, 256), (8, 2048)])
def test_contract_runs_plain_bit_identical_to_pallas(rng, R, W):
    col, val = _sorted_cols(rng, R, W)
    last_t, sum_t = contract.contract_runs(torch.from_numpy(col),
                                           torch.from_numpy(val), N_COLS)
    last_j, sum_j = j_contract_runs(jnp.asarray(col), jnp.asarray(val),
                                    N_COLS)
    np.testing.assert_array_equal(last_t.numpy(), np.asarray(last_j))
    np.testing.assert_array_equal(sum_t.numpy(), np.asarray(sum_j))


def test_contract_runs_plain_bit_identical_past_pallas_width(rng):
    """(4, 4096) is past the Pallas kernel's 2048 limit: held to the XLA
    form, esc._run_boundaries + esc._run_sums."""
    col, val = _sorted_cols(rng, 4, 4096)
    col[1, 0] = -1                  # the sentinel values of the JAX form
    col[2, -1] = -2
    last_t, sum_t = contract.contract_runs(torch.from_numpy(col),
                                           torch.from_numpy(val), N_COLS)
    first, last_j = jesc._run_boundaries(jnp.asarray(col), N_COLS)
    sum_j = jesc._run_sums(jnp.asarray(val), first)
    np.testing.assert_array_equal(last_t.numpy(), np.asarray(last_j))
    np.testing.assert_array_equal(sum_t.numpy(), np.asarray(sum_j))


def test_owner_fill_equal_to_jax(rng):
    """The inputs of test_numerics.py's owner-fill test: rows with no live
    slot, a fully live row, gaps for empty B rows; every slot equal."""
    cap, R = 32, 12
    live = rng.random((R, cap)) < 0.4
    live[3] = False
    live[5] = True
    blen = np.where(live, rng.integers(1, 4, (R, cap)), 0)
    e = (np.cumsum(blen, axis=1) - blen).astype(np.int32)
    pays = [rng.integers(0, 1 << 20, (R, cap)).astype(np.int32)
            for _ in range(2)]
    got_j = jesc._owner_fill(jnp.asarray(live), jnp.asarray(e),
                             tuple(jnp.asarray(p) for p in pays), cap)
    got_t = tesc._owner_fill(torch.from_numpy(live), torch.from_numpy(e),
                             tuple(torch.from_numpy(p) for p in pays), cap)
    for a, b in zip(got_t, got_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _powerlaw(m=200, avg=5, seed=11):
    rs = np.random.RandomState(seed)
    lens = np.minimum((rs.pareto(2.2, m) + 1) * avg * 0.5, m // 4
                      ).astype(np.int64)
    rows = np.repeat(np.arange(m), lens)
    mat = sp.csr_matrix((rs.standard_normal(rows.shape[0]),
                         (rows, rs.randint(0, m, rows.shape[0]))),
                        shape=(m, m))
    mat.sum_duplicates()
    return pt.HostCSR.from_scipy(mat)


def _holes(m=90, seed=5):
    """Empty A rows, and A entries that point at empty B rows."""
    rs = np.random.RandomState(seed)
    mat = sp.random(m, m, 0.08, format="csr", random_state=rs).tolil()
    for r in range(0, m, 6):
        mat[r, :] = 0                   # empty rows of A, and of B = A
    mat = mat.tocsr()
    mat.eliminate_zeros()
    mat.data = rs.standard_normal(mat.nnz)
    return pt.HostCSR.from_scipy(mat)


def _entry_ab():
    return graft._example_matrices()


def _cases():
    a, b = _entry_ab()
    yield "entry", pt.HostCSR.from_host(a), pt.HostCSR.from_host(b), 256
    p = _powerlaw()
    cap = _max_work(p, p) + 3           # wide enough, not a power of two
    yield "powerlaw_cap_not_pow2", p, p, cap
    h = _holes()
    yield "holes", h, h, tentry.fixed_cap(h, h)


def _max_work(a, b):
    blen = np.diff(np.asarray(b.row_offsets, np.int64))
    alen = np.diff(np.asarray(a.row_offsets, np.int64))
    prod = np.add.reduceat(
        np.append(blen[np.asarray(a.col_ids, np.int64)], 0),
        np.asarray(a.row_offsets[:-1], np.int64)) * (alen > 0)
    return int(max(prod.max(), alen.max()))


CASES = {name: (a, b, cap) for name, a, b, cap in _cases()}


@pytest.mark.parametrize("case", list(CASES))
def test_esc_fixed_matches_jax_and_oracle(case):
    a, b, cap = CASES[case]
    assert cap >= _max_work(a, b)
    if case == "holes":
        assert (np.diff(a.row_offsets) == 0).any()
    if case == "powerlaw_cap_not_pow2":
        assert cap & (cap - 1)
    args_t = tentry.esc_args(a, b, "cpu")
    args_j = tuple(jnp.asarray(x.numpy()) for x in args_t)
    cj = jax.jit(partial(jesc.esc_fixed, cap=cap, n_cols=b.cols))(*args_j)
    ct = tesc.esc_fixed(*args_t, cap=cap, n_cols=b.cols)
    counts = np.asarray(cj[0])
    np.testing.assert_array_equal(ct[0].numpy(), counts)
    np.testing.assert_array_equal(ct[1].numpy(), np.asarray(cj[1]))
    inside = np.arange(cap)[None, :] < counts[:, None]
    np.testing.assert_allclose(ct[2].numpy()[inside],
                               np.asarray(cj[2])[inside],
                               rtol=1e-5, atol=1e-6)
    got = padded_to_host_csr(*ct, a.rows, b.cols)
    r = pt.compare_csr(pt.oracle_spgemm(a, b), got, compare_data=True,
                       rel_tol=2e-3)
    assert r.ok, r.message


def test_esc_fixed_empty_a_matches_oracle():
    """A with no nonzeros (the JAX form cannot gather from its empty
    arrays; the port returns empty rows)."""
    a = pt.HostCSR.from_scipy(sp.csr_matrix((5, 7)))
    b = pt.HostCSR.from_scipy(sp.random(
        7, 6, 0.3, format="csr", random_state=np.random.RandomState(0)))
    counts, cols, vals = tesc.esc_fixed(*tentry.esc_args(a, b, "cpu"), cap=4,
                                        n_cols=b.cols)
    assert not counts.any() and cols.shape == (5, 4)
    got = padded_to_host_csr(counts, cols, vals, a.rows, b.cols)
    assert pt.compare_csr(pt.oracle_spgemm(a, b), got).ok


def test_expand_matches_jax():
    a, b = _powerlaw(), _powerlaw()
    cap = tentry.fixed_cap(a, b)
    args = tentry.esc_args(a, b, "cpu")
    m = a.rows
    rows = np.arange(m, dtype=np.int32)
    valid = np.arange(m) % 5 != 2         # some rows switched off
    col_j, val_j, ops_j = jesc._expand(
        jnp.asarray(rows), jnp.asarray(valid),
        *(jnp.asarray(x.numpy()) for x in args), cap, b.cols,
        with_values=True)
    col_t, val_t, ops_t = tesc._expand(
        torch.from_numpy(rows), torch.from_numpy(valid), *args, cap,
        b.cols, with_values=True)
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_j))
    np.testing.assert_allclose(val_t.numpy(), np.asarray(val_j), rtol=1e-6)


def test_entry_on_cpu_matches_graft_entry():
    fj, aj = graft.entry()
    ft, at = tentry.entry(device="cpu")
    for x, y in zip(aj, at):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    cj, ct = jax.jit(fj)(*aj), ft(*at)
    np.testing.assert_array_equal(ct[0].numpy(), np.asarray(cj[0]))
    np.testing.assert_array_equal(ct[1].numpy(), np.asarray(cj[1]))
    np.testing.assert_allclose(ct[2].numpy(), np.asarray(cj[2]), rtol=1e-5,
                               atol=1e-6)


def test_esc_fixed_float64_raises():
    """float64 no longer raises: the entry's matrices in float64 give
    float64 values within 1e-9 of the oracle. Mixed value dtypes promote,
    as in the reference (float64 A times float32 B is float64, within
    1e-9 of the oracle of the rounded B); integer values raise
    TypeError."""
    a, b = (pt.HostCSR.from_host(x) for x in _entry_ab())
    args = list(tentry.esc_args(a, b, "cpu", np.float64))
    out = tesc.esc_fixed(*args, cap=256, n_cols=b.cols)
    assert out[2].dtype == torch.float64
    r = pt.compare_csr(pt.oracle_spgemm(a, b),
                       padded_to_host_csr(*out, a.rows, b.cols),
                       compare_data=True, rel_tol=1e-9)
    assert r.ok, r.message
    args[6] = args[6].float()
    out = tesc.esc_fixed(*args, cap=256, n_cols=b.cols)
    assert out[2].dtype == torch.float64
    b32 = pt.HostCSR(rows=b.rows, cols=b.cols, row_offsets=b.row_offsets,
                     col_ids=b.col_ids,
                     data=np.asarray(b.data, np.float32).astype(np.float64))
    r = pt.compare_csr(pt.oracle_spgemm(a, b32),
                       padded_to_host_csr(*out, a.rows, b.cols),
                       compare_data=True, rel_tol=1e-9)
    assert r.ok, r.message
    args[6] = args[6].int()
    with pytest.raises(TypeError, match="float16, bfloat16"):
        tesc.esc_fixed(*args, cap=256, n_cols=b.cols)


def test_contract_runs_cpu_does_not_count_and_rejects(rng):
    col, val = _sorted_cols(rng, 3, 64)
    n = contract.RUNS_LAUNCHES
    contract.contract_runs(torch.from_numpy(col), torch.from_numpy(val),
                           N_COLS)
    assert contract.RUNS_LAUNCHES == n
    with pytest.raises(ValueError):
        contract.contract_runs(torch.from_numpy(col),
                               torch.from_numpy(val).int(), N_COLS)
    with pytest.raises(ValueError):
        contract.contract_runs(torch.from_numpy(col)[:, :32],
                               torch.from_numpy(val), N_COLS)


@pytest.mark.parametrize("empty", ["a", "b", "both"])
def test_esc_fixed_with_an_operand_without_nonzeros(empty):
    """ROADMAP.md standing decision 15: with an A or a B that has no
    nonzeros, the reference's esc_fixed raises a TypeError (``_expand``
    gathers from an empty ``a_indices`` or ``b_indices``,
    ``speck_tpu/ops/esc.py:187``); the port returns counts of 0, the empty
    C of the oracle."""
    rs = np.random.RandomState(3)
    a = sp.random(90, 40, 0.0 if empty in ("a", "both") else 0.1,
                  format="csr", random_state=rs)
    b = sp.random(40, 70, 0.0 if empty in ("b", "both") else 0.1,
                  format="csr", random_state=rs)
    ah, bh = pt.HostCSR.from_scipy(a), pt.HostCSR.from_scipy(b)
    cap = tentry.fixed_cap(ah, bh)
    args = tentry.esc_args(ah, bh, "cpu")
    out = tesc.esc_fixed(*args, cap=cap, n_cols=bh.cols)
    assert int(out[0].sum()) == 0
    C = padded_to_host_csr(*out, ah.rows, bh.cols)
    r = pt.compare_csr(pt.oracle_spgemm(ah, bh), C, compare_data=True)
    assert r.ok and C.nnz == 0, r.message
    with pytest.raises(TypeError):
        jax.jit(partial(jesc.esc_fixed, cap=cap, n_cols=bh.cols))(
            *(jnp.asarray(x.numpy()) for x in args))
