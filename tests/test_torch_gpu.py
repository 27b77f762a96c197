"""The port's CUDA kernels on the card, against their plain torch versions,
and the slice end to end through them. Every test here needs a CUDA card
(marker ``gpu``) and skips without one. The file imports no jax, so it
also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances: masks, keys and structure exact; contract sums within
1e-6 + 1e-5 * (sum of |val| over the run prefix), the fp32 bound for a
sum taken in another order (the kernel's segmented scan against the plain
doubling); per-row (key, payload) multisets exact (the bitonic network
is not stable); the gather probes and esc_fixed's structure exact, its
values within rel_tol 2e-3 of the scipy oracle."""

import numpy as np
import pytest
import torch

import speck_tpu_torch as pt
from speck_tpu_torch import entry as tentry
from speck_tpu_torch.ops import bitonic, contract
from speck_tpu_torch.ops.esc import esc_fixed
from speck_tpu_torch.parallel import padded_to_host_csr
from speck_tpu_torch.probes import gather_microbench2 as gm
from speck_tpu_torch.utils.generators import make_banded, make_powerlaw

N_COLS = 300


@pytest.fixture()
def rs():
    return np.random.default_rng(20261016)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def sorted_rect(rs, R, W, const_rid):
    """(rid, col, val) rows sorted by (rid, col), duplicate runs, dead
    slots (col == N_COLS) at each row's end."""
    rid = np.zeros((R, W), np.int32)
    col = np.full((R, W), N_COLS, np.int32)
    for r in range(R):
        live = int(rs.integers(W // 2, W + 1))
        if const_rid:
            rid[r] = 7 + r
            c = np.sort(rs.integers(0, N_COLS, live))
        else:
            rr = np.sort(rs.integers(0, 6, live))
            c = rs.integers(0, 40, live)
            order = np.lexsort((c, rr))
            rr, c = rr[order], c[order]
            rid[r, :live] = rr
            rid[r, live:] = rr[-1]
        col[r, :live] = c
    return rid, col, rs.standard_normal((R, W)).astype(np.float32)


def assert_same_pairs(key, pay, key_o, pay_o):
    """Sorted keys, and per row the same multiset of (key, payload)."""
    np.testing.assert_array_equal(key_o, np.sort(key, axis=1))

    def pairs(k, p):
        x = (k.astype(np.int64) << 32) | (p.astype(np.int64) & 0xffffffff)
        return np.sort(x, axis=1)

    np.testing.assert_array_equal(pairs(key_o, pay_o), pairs(key, pay))


@pytest.mark.gpu
@pytest.mark.parametrize("R,W,const_rid", [(16, 8192, False),
                                           (2, 65536, True), (3, 1, False),
                                           (5, 3000, False)])
def test_contract_kernel_matches_plain(rs, cuda_device, R, W, const_rid):
    rid, col, val = sorted_rect(rs, R, W, const_rid)
    args = [torch.from_numpy(x) for x in (rid, col, val)]
    last_p, sum_p = contract.contract_plain(*args, N_COLS)
    dev_args = [x.to(cuda_device) for x in args]
    if const_rid:  # the per-row broadcast form the levels use
        dev_args[0] = dev_args[0][:, :1].contiguous().expand(R, W)
    n0 = contract.LAUNCHES
    last_k, sum_k = contract.stream_contract(*dev_args, N_COLS)
    torch.cuda.synchronize()
    assert contract.LAUNCHES == n0 + 1
    assert torch.equal(last_k.cpu(), last_p)
    # fp32 summation error scales with the sum of magnitudes in the run
    # prefix, not with the (possibly cancelled) sum itself
    mag = contract.contract_plain(args[0], args[1], args[2].abs(), N_COLS)[1]
    err = (sum_k.cpu() - sum_p).abs()
    assert bool((err <= 1e-6 + 1e-5 * mag).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("R,W", [(64, 256), (32, 2048), (3, 1), (5, 3000),
                                 (2, 70000)])
def test_contract_runs_kernel_matches_plain(rs, cuda_device, R, W):
    _, col, val = sorted_rect(rs, R, W, const_rid=True)
    col[0, 0] = -1                     # the column form's sentinel values
    col[-1, -1] = -2
    col, val = torch.from_numpy(col), torch.from_numpy(val)
    last_p, sum_p = contract.contract_runs_plain(col, val, N_COLS)
    n0 = contract.RUNS_LAUNCHES
    last_k, sum_k = contract.contract_runs(col.to(cuda_device),
                                           val.to(cuda_device), N_COLS)
    torch.cuda.synchronize()
    assert contract.RUNS_LAUNCHES == n0 + 1
    assert torch.equal(last_k.cpu(), last_p)
    mag = contract.contract_runs_plain(col, val.abs(), N_COLS)[1]
    err = (sum_k.cpu() - sum_p).abs()
    assert bool((err <= 1e-6 + 1e-5 * mag).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("S,rows", [(2048, 3000), (100, 17), (3000, 5)])
def test_sublane_gather_kernel_matches_plain(rs, cuda_device, S, rows):
    tab = torch.from_numpy(rs.standard_normal((S, 128)).astype(np.float32))
    idx = torch.from_numpy(rs.integers(0, S, (rows, 128)).astype(np.int32))
    n0 = gm.LAUNCHES["sublane_gather"]
    got = gm.sublane_gather(idx.to(cuda_device), tab.to(cuda_device))
    torch.cuda.synchronize()
    assert gm.LAUNCHES["sublane_gather"] == n0 + 1
    assert torch.equal(got.cpu(), gm.sublane_gather_plain(idx, tab))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [128, 384])
def test_run_copy_kernel_matches_plain(rs, cuda_device, L):
    n = 5003
    src = torch.from_numpy(rs.standard_normal(n).astype(np.float32))
    offs = rs.integers(0, n - L + 1, (33, 7)).astype(np.int32)
    offs[0, :4] = [0, 1, 2, 3]         # every alignment
    offs[-1, -1] = n - L               # the source's last element
    offs = torch.from_numpy(offs)
    n0 = gm.LAUNCHES["run_copy"]
    got = gm.run_copy(offs.to(cuda_device), src.to(cuda_device), L)
    torch.cuda.synchronize()
    assert gm.LAUNCHES["run_copy"] == n0 + 1
    assert torch.equal(got.cpu(), gm.run_copy_plain(offs, src, L))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["entry", "banded", "powerlaw"])
def test_esc_fixed_on_card_matches_oracle(cuda_device, case):
    if case == "entry":
        a, b = tentry._example_matrices()
    elif case == "banded":
        a = b = make_banded(3000, half_band=4, seed=3)
    else:
        a = b = make_powerlaw(400, avg=4, seed=3)
    cap = 256 if case == "entry" else tentry.fixed_cap(a, b)
    args = tentry.esc_args(a, b, cuda_device)
    n1, n2 = contract.RUNS_LAUNCHES, bitonic.LAUNCHES
    out = esc_fixed(*args, cap=cap, n_cols=b.cols)
    torch.cuda.synchronize()
    assert contract.RUNS_LAUNCHES > n1 and bitonic.LAUNCHES > n2
    got = padded_to_host_csr(*out, a.rows, b.cols)
    r = pt.compare_csr(pt.oracle_spgemm(a, b), got, compare_data=True,
                       rel_tol=2e-3)
    assert r.ok, r.message


@pytest.mark.gpu
@pytest.mark.parametrize("R,W,n_pay", [(8, 8192, 3), (2, 1 << 17, 1),
                                       (4, 64, 0), (3, 1 << 15, 2),
                                       (2, 1, 1)])
def test_sort_kernel_matches_plain(rs, cuda_device, R, W, n_pay):
    key = rs.integers(0, 1 << 20, size=(R, W)).astype(np.int32)
    key[:, : W // 4] = np.iinfo(np.int32).max
    pays = [rs.integers(-9, 9, size=(R, W)).astype(np.int32)
            for _ in range(n_pay)]
    n0 = bitonic.LAUNCHES
    k_k, p_k = bitonic.row_sort(torch.from_numpy(key).to(cuda_device),
                                [torch.from_numpy(p).to(cuda_device)
                                 for p in pays])
    torch.cuda.synchronize()
    assert bitonic.LAUNCHES == n0 + 1
    for p, po in zip(pays, p_k):
        assert_same_pairs(key, p, k_k.cpu().numpy(), po.cpu().numpy())
    if not pays:
        np.testing.assert_array_equal(k_k.cpu().numpy(), np.sort(key, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(stream_width=64, product_budget=1 << 12),
                                dict(stream_width=64, product_budget=1 << 12,
                                     fused_staging_budget=0),
                                dict(stream_width=64, product_budget=1 << 12,
                                     stream_max_width=64)])
def test_spgemm_on_card_matches_oracle(cuda_device, kw):
    h = make_powerlaw(3000, avg=6, seed=3)
    cfg = pt.SpgemmConfig(**kw)
    A = pt.device_put_csr(h, torch.float32, cuda_device)
    n1, n2 = contract.LAUNCHES, bitonic.LAUNCHES
    plan = pt.plan_spgemm(A, A, cfg)
    C = pt.device_get_csr(plan.execute())
    assert contract.LAUNCHES > n1 and bitonic.LAUNCHES > n2
    assert plan.stream.layout.n_wide > 0
    r = pt.compare_csr(pt.oracle_spgemm(h, h), C, compare_data=True,
                       rel_tol=2e-3)
    assert r.ok, r.message
