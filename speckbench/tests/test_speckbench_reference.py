"""The plain reference against scipy, and the faults its comparison
catches."""

import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from speckbench import reference
from speckbench.generators import kronecker, stencil27
from speckbench.inputs import draw_values


def case(kind):
    if kind == "graph":
        st = kronecker.structure({"SCALE": 8, "edgefactor": 16, "graph_seed":
                                  5, "initiator": [0.57, 0.19, 0.19, 0.05]},
                                 4)
        v = draw_values(st, {"values": "uniform", "value_dtype": "float32"},
                        4, 0, "cpu")
    else:
        st = stencil27.structure({"nx": 7, "ny": 6, "nz": 5}, 0)
        v = draw_values(st, {"values": "normal", "value_dtype": "float64"},
                        4, 0, "cpu")
    a = sp.csr_matrix((v.double().numpy(), st.indices, st.indptr),
                      shape=(st.rows, st.cols))
    c = (a @ a).tocsr()
    c.sort_indices()
    return reference.Operand.of(st, v), c


def parts(c, dtype):
    return (torch.as_tensor(c.indptr.astype(np.int32)),
            torch.as_tensor(c.indices.astype(np.int32)),
            torch.as_tensor(c.data).to(dtype), c.shape)


@pytest.mark.parametrize("kind", ["graph", "stencil"])
@pytest.mark.parametrize("budget", [1 << 26, 1000])
def test_reference_matches_scipy(kind, budget):
    op, c = case(kind)
    found = reference.compare(*parts(c, op.v.dtype), op, op, budget=budget)
    assert found["struct_rows"] == 0
    assert found["val_err"] < (1e-6 if op.v.dtype == torch.float32
                               else 1e-13)


def test_block_product_rows_sorted_and_complete():
    op, c = case("graph")
    cs = reference.product_counts(op.st, op.st)
    blocks = reference.row_blocks(op.st, cs, 2000)
    assert len(blocks) > 3 and blocks[0][0] == 0 and blocks[-1][1] == op.st.rows
    cols, vals = [], []
    for r0, r1 in blocks:
        counts, col, val, mag = reference.block_product(op, op, cs, r0, r1)
        np.testing.assert_array_equal(counts.numpy(), np.diff(c.indptr[r0:r1 + 1]))
        assert bool((mag >= val.abs()).all())
        cols.append(col.numpy())
        vals.append(val.numpy())
    np.testing.assert_array_equal(np.concatenate(cols), c.indices)
    np.testing.assert_allclose(np.concatenate(vals), c.data, rtol=1e-12)


def test_comparison_catches_a_perturbed_value():
    op, c = case("stencil")
    ip, ix, data, shape = parts(c, torch.float64)
    data[len(data) // 3] *= 1 + 1e-7
    found = reference.compare(ip, ix, data, shape, op, op)
    assert found["struct_rows"] == 0 and found["val_err"] > 1e-10


def test_comparison_catches_a_dropped_entry():
    op, c = case("graph")
    c = c.copy()
    c.data[5] = 0.0
    c.eliminate_zeros()
    found = reference.compare(*parts(c, torch.float32), op, op)
    assert found["struct_rows"] == 1


def test_comparison_catches_unsorted_rows_and_bad_offsets():
    op, c = case("graph")
    ip, ix, data, shape = parts(c, torch.float32)
    r = next(r for r in range(c.shape[0]) if ip[r + 1] - ip[r] > 1)
    s = int(ip[r])
    ix[s], ix[s + 1] = ix[s + 1].clone(), ix[s].clone()
    assert reference.compare(ip, ix, data, shape, op, op)["struct_rows"] == 1
    bad = ip.clone()
    bad[-1] += 1
    found = reference.compare(bad, ix, data, shape, op, op)
    assert found == {"struct_rows": op.st.rows, "val_err": math.inf}


def test_rel_err_zero_magnitude_and_nan():
    z = torch.zeros(2, dtype=torch.float64)
    one = torch.ones(2, dtype=torch.float64)
    assert reference.rel_err(z, z, z) == 0.0
    assert reference.rel_err(one, z, z) == math.inf
    assert reference.rel_err(torch.tensor([math.nan]), z[:1], one[:1]) == math.inf
