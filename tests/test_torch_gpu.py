"""The port's CUDA kernels on the card, against their plain torch versions,
and the slice end to end through them. Every test here needs a CUDA card
(marker ``gpu``) and skips without one. The file imports no jax, so it
also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances: masks, keys and structure exact; contract sums within
1e-6 + 1e-5 * (sum of |val| over the run prefix), the fp32 bound for a
sum taken in another order (the kernel's segmented scan against the plain
doubling); per-row (key, payload) multisets exact (the bitonic network
is not stable)."""

import numpy as np
import pytest
import torch

import speck_tpu_torch as pt
from speck_tpu_torch.ops import bitonic, contract
from speck_tpu_torch.utils.generators import make_powerlaw

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
