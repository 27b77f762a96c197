"""A chain of products over several operands: the prolongation generator,
the chain reference against scipy, whole runs of tiny chain cells on the
CPU, and the faults and the control that must read not correct."""

import dataclasses
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import speck_tpu_torch
from speckbench import reference
from speckbench import run as R
from speckbench.generators import prolong_trilinear, stencil27
from speckbench.inputs import draw_values
from speckbench.operands import check_steps

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4099
GALERKIN = [["PT", "transpose", "P"], ["AP", "spgemm", "A", "P"],
            ["C", "spgemm", "PT", "AP"]]


def scipy_of(op):
    st = op.st
    return sp.csr_matrix((op.v.double().numpy(), st.indices, st.indptr),
                         shape=(st.rows, st.cols))


def galerkin_operands(n):
    cfg = {"nx": n, "ny": n, "nz": n, "values": "normal",
           "value_dtype": "float64"}
    st = stencil27.structure(cfg, 0)
    pst, pv = prolong_trilinear.operand(cfg, {"coarsen": 2})
    return {"A": reference.Operand.of(st, draw_values(st, cfg, 7, 0, "cpu")),
            "P": reference.Operand.of(pst, torch.as_tensor(pv))}


def test_prolongation_at_hpcg_size():
    n = 104
    st, w = prolong_trilinear.operand({"nx": n, "ny": n, "nz": n},
                                      {"coarsen": 2})
    assert (st.rows, st.cols, st.nnz) == (1124864, 140608, 3723875)
    assert w.dtype == np.float64 and bool((w > 0).all())
    lens = np.diff(st.indptr)
    assert set(np.unique(lens)) == {1, 2, 4, 8}
    same_row = np.repeat(np.arange(st.rows), lens)
    step = np.diff(st.indices.astype(np.int64))
    assert bool((step[same_row[1:] == same_row[:-1]] > 0).all())
    sums = np.add.reduceat(w, st.indptr[:-1])
    z, y, x = np.unravel_index(np.arange(st.rows), (n, n, n))
    inner = (x < n - 1) & (y < n - 1) & (z < n - 1)
    np.testing.assert_array_equal(sums[inner], 1.0)
    assert bool((sums[~inner] < 1.0).all())
    # fine point 2c of each axis is coarse point c alone, at weight 1
    p = sp.csr_matrix((w, st.indices, st.indptr), shape=(st.rows, st.cols))
    fine = (4 * n + 2) * n + 14                     # (z, y, x) = (4, 2, 14)
    assert p[fine].nnz == 1 and p[fine, (2 * 52 + 1) * 52 + 7] == 1.0


def test_prolongation_on_odd_and_even_sides():
    # an odd side ends on a coarse point (weight 1), an even one past it
    st, w = prolong_trilinear.operand({"nx": 7, "ny": 6, "nz": 5},
                                      {"coarsen": 2})
    assert (st.rows, st.cols) == (210, 4 * 3 * 3)
    p = sp.csr_matrix((w, st.indices, st.indptr), shape=(st.rows, st.cols))
    sums = np.asarray(p.sum(1)).ravel().reshape(5, 6, 7)
    np.testing.assert_array_equal(sums[:, :5, :], 1.0)
    np.testing.assert_array_equal(sums[:, 5, :], 0.5)
    for r in range(st.rows):
        row = st.indices[st.indptr[r]:st.indptr[r + 1]]
        assert bool((np.diff(row) > 0).all())


@pytest.mark.parametrize("budget", [1 << 26, 5000])
def test_chain_reference_matches_scipy(budget):
    # stencil27 at 8^3, coarse 4^3
    ops = galerkin_operands(8)
    a, p = scipy_of(ops["A"]), scipy_of(ops["P"])
    want = (p.T @ (a @ p)).tocsr()
    want.sort_indices()
    pt = reference.transpose(ops["P"])
    ap = reference.product(ops["A"], ops["P"], budget)
    c = reference.product(pt, ap, budget)
    assert (c.st.rows, c.st.cols) == (64, 64)
    np.testing.assert_array_equal(c.st.indptr, want.indptr)
    np.testing.assert_array_equal(c.st.indices, want.indices)
    np.testing.assert_allclose(c.v.numpy(), want.data, rtol=1e-12, atol=0)
    # the magnitude plane carried through the chain: |Pt| (|A| |P|)
    mag = (abs(p).T @ (abs(a) @ abs(p))).tocsr()
    mag.sort_indices()
    np.testing.assert_allclose(c.m.numpy(), mag.data, rtol=1e-12, atol=0)
    found = reference.check(torch.as_tensor(want.indptr.astype(np.int32)),
                            torch.as_tensor(want.indices.astype(np.int32)),
                            torch.as_tensor(want.data), want.shape, ops,
                            GALERKIN, budget)
    assert found["struct_rows"] == 0 and found["val_err"] < 1e-13


def test_transpose_reference_moves_values_and_magnitudes():
    ops = galerkin_operands(6)
    a = ops["A"]
    t = reference.transpose(a)
    want = scipy_of(a).T.tocsr()
    want.sort_indices()
    np.testing.assert_array_equal(t.st.indptr, want.indptr)
    np.testing.assert_array_equal(t.st.indices, want.indices)
    np.testing.assert_array_equal(t.v.numpy(), want.data)
    np.testing.assert_array_equal(t.m.numpy(), np.abs(want.data))


@pytest.mark.parametrize("steps", [
    [], [["C", "transpose", "A"]], [["C", "spgemm", "A", "Q"]],
    [["C", "spgemm", "A"]], [["C", "mul", "A", "A"]],
    [["C", "spgemm", "A", "C"]]])
def test_malformed_steps_are_refused(steps):
    with pytest.raises(ValueError):
        check_steps(steps, ["A", "P"])


def test_the_chain_cell_is_correct(tiny):
    res = R.run(tiny, "hs.galerkin", SEED, 0.3, False, CPU)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["struct_rows"] == {"value": 0, "limit": 0}
    assert res["checks"]["val_err"]["value"] < 1e-13
    json.loads(json.dumps(res))


def test_the_chain_cell_traced_reports_the_stages(tiny):
    res = R.run(tiny, "hs.galerkin", SEED, 0.3, True, CPU)
    assert res["correct"]
    assert set(res["metrics"]) == {"plan_ms", "count_ms", "numeric_ms"}


@pytest.mark.parametrize("steps", [
    [["AP", "spgemm", "A", "P"]],
    [["AT", "transpose", "A"], ["AAT", "spgemm", "A", "AT"]],
    [["PT", "transpose", "P"], ["PTA", "spgemm", "PT", "A"],
     ["C", "spgemm", "PTA", "P"]]])
def test_an_added_chain_is_found_by_name(tiny, steps):
    # a traffic mix that exists only under the test's own directory
    (tiny.roots[0] / "traffic" / "chain2.json").write_text(json.dumps(
        {"entry": "chain", "steps": steps,
         "operands": {"P": {"generator": "prolong_trilinear",
                            "coarsen": 2}}}))
    tiny.m["workloads"].append({"name": "hs.chain2", "config": "hs",
                                "traffic": "chain2", "chips": 1})
    res = R.run(tiny, "hs.chain2", SEED, 0.2, False, CPU)
    assert res["correct"] and res["attempted"] >= 1


def drop_one(T):
    """T less one entry of a row that holds several."""
    ip = T.indptr.long()
    r = int(((ip[1:] - ip[:-1]) > 1).nonzero()[T.shape[0] // 3])
    s = int(ip[r])
    keep = torch.ones(T.nnz, dtype=torch.bool)
    keep[s] = False
    ip = ip.clone()
    ip[r + 1:] -= 1
    return dataclasses.replace(T, indptr=ip.to(T.indptr.dtype),
                               indices=T.indices[:T.nnz][keep],
                               data=T.data[:T.nnz][keep], nnz=T.nnz - 1)


def test_a_dropped_entry_of_the_transpose_is_not_correct(tiny, monkeypatch):
    orig = speck_tpu_torch.transpose
    monkeypatch.setattr(speck_tpu_torch, "transpose",
                        lambda A: drop_one(orig(A)))
    res = R.run(tiny, "hs.galerkin", SEED, 0.2, False, CPU)
    assert not res["correct"]


def test_an_altered_value_of_a_p_is_not_correct(tiny, monkeypatch):
    orig = speck_tpu_torch.spgemm

    def alter_ap(A, B, cfg=None, timings=None):
        C = orig(A, B, cfg, timings)
        if B.shape[0] != B.shape[1]:  # A P: the right operand is P
            data = C.data.clone()
            data[C.nnz // 2] += 1.0
            C = dataclasses.replace(C, data=data)
        return C

    monkeypatch.setattr(speck_tpu_torch, "spgemm", alter_ap)
    res = R.run(tiny, "hs.galerkin", SEED, 0.2, False, CPU)
    assert res["checks"]["struct_rows"]["value"] == 0
    assert not res["correct"]


def test_the_chain_control_is_not_correct(tiny):
    # every operand of the program one precision below the configuration's
    res = R.run(tiny, "hs.galerkin", SEED, 0.2, False, CPU, torch.float32)
    assert res["checks"]["struct_rows"]["value"] == 0
    assert not res["correct"]


@pytest.mark.parametrize("kind", ["graph", "stencil"])
def test_an_explicit_magnitude_plane_reads_as_none(kind):
    # the A*A cells: a plane of |v| gives the readings of no plane, to the bit
    from speckbench.tests.test_speckbench_reference import case, parts

    op, c = case(kind)
    ip, ix, data, shape = parts(c, op.v.dtype)
    data[len(data) // 2] *= 1 + 1e-5
    with_m = dataclasses.replace(op, m=op.v.double().abs())
    for budget in (1 << 26, 1000):
        plain = reference.compare(ip, ix, data, shape, op, op, budget)
        assert reference.compare(ip, ix, data, shape, with_m, with_m,
                                 budget) == plain
        assert reference.check(ip, ix, data, shape, {"A": op},
                               [["C", "spgemm", "A", "A"]], budget) == plain
        assert plain["val_err"] > 0
