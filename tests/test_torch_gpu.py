"""The port's CUDA kernels on the card, against their plain torch versions,
and the slice end to end through them. Every test here needs a CUDA card
(marker ``gpu``) and skips without one. The file imports no jax, so it
also runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances: masks, keys and structure exact; contract sums within
1e-6 + 1e-5 * (sum of |val| over the run prefix), the fp32 bound for a
sum taken in another order (the kernel's segmented scan against the plain
doubling); 16-bit contract sums within the 16-bit bound 2 (n + 1)
(u |terms| + eta) of the plain version's (utils/compare.py); the row
sort's keys and every payload equal to the plain stable sort's, bit for
bit (both are stable), at any width; the gather probes exactly equal to
their plain versions and torch.gather; esc_fixed's structure exact, its
values within rel_tol 2e-3 of the scipy oracle."""

import numpy as np
import pytest
import torch

import speck_tpu_torch as pt
from speck_tpu_torch import entry as tentry
from speck_tpu_torch.ops import bitonic, contract
from speck_tpu_torch.ops.esc import esc_fixed
from speck_tpu_torch.parallel import padded_to_host_csr
from speck_tpu_torch.probes import conformance as cf
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
            rid[r, live:] = rr[-1] if live else 0
        col[r, :live] = c
    return rid, col, rs.standard_normal((R, W)).astype(np.float32)


def sort_on_card(device, key, pays):
    """K2 on the card against sort_plain on the CPU: one launch, keys and
    payloads equal bit for bit."""
    n0 = bitonic.LAUNCHES
    k_k, p_k = bitonic.row_sort(torch.from_numpy(key).to(device),
                                [torch.from_numpy(p).to(device)
                                 for p in pays])
    torch.cuda.synchronize()
    assert bitonic.LAUNCHES == n0 + 1
    k_p, p_p = bitonic.sort_plain(torch.from_numpy(key),
                                  [torch.from_numpy(p) for p in pays])
    assert torch.equal(k_k.cpu(), k_p)
    for a, b in zip(p_k, p_p):
        assert a.dtype == b.dtype
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


T = contract.TILE


def contract_rect(rs, R, W, kind):
    """(rid, col, val) of one K1 case, and whether the rid is per row.
    False and True: sorted_rect with a rid plane or a per-row rid;
    "rid_edge": one row whose run key changes only by its rid, exactly at
    each tile edge (one column throughout); "one_col": one row that is all
    one column (runs of many tiles); "pad3q": rows whose last three
    quarters are the dead column, a per-row rid."""
    if kind in (False, True):
        return sorted_rect(rs, R, W, kind) + (kind,)
    g = np.arange(R * W).reshape(R, W)
    val = rs.standard_normal((R, W)).astype(np.float32)
    if kind == "rid_edge":
        return (g // T).astype(np.int32), np.full((R, W), 5, np.int32), \
            val, False
    if kind == "one_col":
        return np.zeros((R, W), np.int32), np.full((R, W), 9, np.int32), \
            val, False
    rid = np.repeat(np.arange(R, dtype=np.int32)[:, None] + 3, W, 1)
    col = np.sort(rs.integers(0, N_COLS, (R, W)), 1).astype(np.int32)
    col[:, W // 4:] = N_COLS
    return rid, col, val, True


def contract_on_card(device, rid, col, val, per_row):
    args = [torch.from_numpy(x) for x in (rid, col, val)]
    dev_args = [x.to(device) for x in args]
    R, W = col.shape
    if per_row:  # the per-row broadcast form the levels use (stride 0)
        dev_args[0] = dev_args[0][:, 0].contiguous().as_strided((R, W),
                                                                (1, 0))
    n0 = contract.LAUNCHES
    last_k, sum_k = contract.stream_contract(*dev_args, N_COLS)
    torch.cuda.synchronize()
    assert contract.LAUNCHES == n0 + 1
    return args, dev_args, last_k, sum_k


@pytest.mark.gpu
@pytest.mark.parametrize("R,W,kind", [
    (16, 8192, False), (2, 65536, True), (3, 1, False), (5, 3000, False),
    # tile edges: W = T - 1, T, T + 1 (R * W not a multiple of T but at T)
    (3, 4095, False), (2, 4096, False), (3, 4097, True), (5, 4097, False),
    (1, 3 * 4096, "rid_edge"), (2, 5 * 4096 + 7, "rid_edge"),
    (1, 1 << 18, "one_col"), (3, 70001, "one_col"), (4, 40000, "pad3q"),
    (1, 1 << 20, True), (3, 70000, True), (5000, 1, True),
    (9001, 1, False)])
def test_contract_kernel_matches_plain(rs, cuda_device, R, W, kind):
    rid, col, val, per_row = contract_rect(rs, R, W, kind)
    args, _, last_k, sum_k = contract_on_card(cuda_device, rid, col, val,
                                              per_row)
    last_p, sum_p = contract.contract_plain(*args, N_COLS)
    assert torch.equal(last_k.cpu(), last_p)
    # fp32 summation error scales with the sum of magnitudes in the run
    # prefix, not with the (possibly cancelled) sum itself
    mag = contract.contract_plain(args[0], args[1], args[2].abs(), N_COLS)[1]
    err = (sum_k.cpu() - sum_p).abs()
    assert bool((err <= 1e-6 + 1e-5 * mag).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("R,W,kind", [(1, 1 << 20, "sorted"),
                                      (64, 8192, False)])
def test_contract_kernel_is_deterministic(rs, cuda_device, R, W, kind):
    """Two launches on the same input give bit-identical sums and masks:
    the look-back folds its carry in tile order whichever tile had
    published. (1, 2^20): 40 columns, runs of about 6 tiles."""
    if kind == "sorted":
        col = np.sort(rs.integers(0, 40, (R, W)), 1).astype(np.int32)
        rid = np.zeros((R, W), np.int32)
        val = rs.standard_normal((R, W)).astype(np.float32)
        per_row = False
    else:
        rid, col, val, per_row = contract_rect(rs, R, W, kind)
    _, dev_args, last_1, sum_1 = contract_on_card(cuda_device, rid, col, val,
                                                  per_row)
    for _ in range(3):
        last_2, sum_2 = contract.stream_contract(*dev_args, N_COLS)
        torch.cuda.synchronize()
        assert torch.equal(last_1, last_2)
        assert torch.equal(sum_1.view(torch.int32), sum_2.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["rid", "col", "val", "runs"])
def test_contract_kernels_reject_unaligned_planes(cuda_device, which):
    """The kernels load 16 bytes at a time: a plane that starts off a
    16-byte boundary raises, and nothing is launched."""
    def plane(dtype, off):  # a contiguous (2, 64) plane, off slots in
        return torch.zeros(128 + off, dtype=dtype,
                           device=cuda_device)[off:].view(2, 64)

    rid = plane(torch.int32, int(which == "rid"))
    col = plane(torch.int32, int(which in ("col", "runs")))
    val = plane(torch.float32, int(which == "val"))
    n0 = contract.LAUNCHES + contract.RUNS_LAUNCHES
    with pytest.raises(ValueError, match="16-byte aligned"):
        if which == "runs":
            contract.contract_runs(col, val, N_COLS)
        else:
            contract.stream_contract(rid, col, val, N_COLS)
    assert contract.LAUNCHES + contract.RUNS_LAUNCHES == n0


@pytest.mark.gpu
@pytest.mark.parametrize("R,W", [(64, 256), (32, 2048), (3, 1), (5, 3000),
                                 (2, 70000), (3, 4095), (2, 4097),
                                 (1, 1 << 20), (4097, 1)])
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
    sort_on_card(cuda_device, key, pays)


I32 = np.iinfo(np.int32)


def range_keys(rs, case, R, W):
    """Keys of one K2 case: each spans the digit passes its name says."""
    if case == "equal":                         # no pass
        return np.full((R, W), -77, np.int32)
    if case == "negative":                      # both ends of int32
        key = rs.integers(I32.min, I32.max, size=(R, W), endpoint=True)
        key[:, :5] = [I32.min, I32.max, -1, 0, I32.min]
        return key.astype(np.int32)
    if case.startswith("digits"):               # 8, 16, 24, 32-bit spans
        bits = 8 * int(case[-1])
        lo = int(rs.integers(-(1 << 30), 1 << 30))
        key = lo + rs.integers(0, 1 << bits, size=(R, W), dtype=np.int64)
        key[:, 0], key[:, -1] = lo, lo + (1 << bits) - 1
        return np.clip(key, I32.min, I32.max).astype(np.int32)
    if case == "pads":                          # INT32_MAX over a quarter
        key = rs.integers(0, 300, size=(R, W)).astype(np.int32)
        key[:, rs.permutation(W)[: W // 4]] = I32.max
        return key
    if case == "rank":                          # rank, or W + t
        last = rs.random((R, W)) < 0.3
        rank = np.cumsum(last, axis=1) - 1
        return np.where(last, rank, W + np.arange(W)).astype(np.int32)
    if case == "multi_wide":                    # several tiles, any key
        return rs.integers(I32.min, I32.max, size=(R, W),
                           endpoint=True).astype(np.int32)
    # several tiles, many equal keys across tiles, pads
    key = rs.integers(-500, 500, size=(R, W)).astype(np.int32)
    key[:, rs.permutation(W)[: W // 8]] = I32.max
    return key


def special_floats(rs, R, W):
    """float32 payload bits with NaNs of several patterns, -0.0 and
    infinities among normal values."""
    x = rs.standard_normal((R, W)).astype(np.float32).view(np.int32)
    special = np.array([0x7fc00000, 0x7fc00001, 0xffc00000, 0x7f800001,
                        0x80000000, 0x7f800000, 0xff800000],
                       np.uint32).view(np.int32)
    pick = rs.random((R, W)) < 0.2
    x[pick] = special[rs.integers(0, len(special), int(pick.sum()))]
    return x.view(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("case,R,W,n_pay", [
    ("equal", 4, 4096, 2), ("equal", 2, 1 << 15, 1),
    ("negative", 3, 8192, 1), ("negative", 2, 1 << 14, 2),
    ("digits1", 5, 2048, 1), ("digits2", 5, 4096, 2),
    ("digits3", 2, 8192, 3), ("digits4", 2, 8192, 0),
    ("pads", 4, 1024, 3), ("rank", 6, 2048, 2), ("rank", 3, 256, 1),
    ("digits2", 7, 1, 1), ("digits2", 9, 2, 2), ("digits3", 5, 16, 3),
    ("multi", 1, 1 << 15, 3), ("multi", 2, 1 << 17, 1),
    ("multi", 3, 1 << 20, 2), ("multi_wide", 2, 1 << 16, 0)])
def test_sort_kernel_key_ranges(rs, cuda_device, case, R, W, n_pay):
    key = range_keys(rs, case, R, W)
    pays = [rs.integers(I32.min, I32.max, size=(R, W),
                        endpoint=True).astype(np.int32)
            for _ in range(n_pay - 1)]
    if n_pay:
        pays.append(special_floats(rs, R, W))
    sort_on_card(cuda_device, key, pays)


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


def _dia_case(case):
    """(matrix, dtype, config) of one diagonal-plane route."""
    from speck_tpu_torch.utils.generators import make_mixed, make_stencil27

    if case == "dia":
        return make_banded(3000, half_band=4, seed=3), torch.float32, {}
    if case == "sdia":
        return (make_stencil27(12, seed=19), torch.float32,
                dict(host_analysis_max_nnz=16))
    if case == "fp64":
        return make_banded(2000, half_band=3, seed=9), torch.float64, {}
    return make_mixed(4096, 4, 48, 12, seed=13), torch.float32, {}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dia", "sdia", "fp64", "dia_rows"])
@pytest.mark.parametrize("new_values", [False, True])
def test_dia_routes_on_card_match_the_cpu(cuda_device, case, new_values):
    """Each diagonal-plane route on the card against the port on the CPU:
    the same route, structure equal, values within rtol 1e-5 (float32) or
    1e-12 (float64); with new values through plan reuse too."""
    h, dtype, kw = _dia_case(case)
    cfg = pt.SpgemmConfig(**kw)
    out = []
    for dev in (cuda_device, "cpu"):
        A = pt.device_put_csr(h, dtype, dev)
        plan = pt.plan_spgemm(A, A, cfg)
        if new_values:
            h2 = pt.HostCSR.from_parts(h.rows, h.cols, h.row_offsets,
                                       h.col_ids, h.data * -1.5 + 0.125)
            A2 = pt.device_put_csr(h2, dtype, dev)
            C = plan.execute(A2, A2)
        else:
            C = plan.execute()
        out.append((plan, pt.device_get_csr(C)))
    (pc, cc), (pp, cp_) = out
    if case == "dia_rows":
        assert pc.dia is None and pc.dia_rows is not None
        assert pp.dia_rows is not None
        assert torch.equal(pc.dia_rows.present.cpu(), pp.dia_rows.present)
    else:
        assert pc.dia is not None and pp.dia is not None
        assert (pc.dia.off_a is not None) == (case == "sdia")
        assert pc.dia.uniform == pp.dia.uniform
        assert torch.equal(pc.dia.present.cpu(), pp.dia.present)
    np.testing.assert_array_equal(cc.row_offsets, cp_.row_offsets)
    np.testing.assert_array_equal(cc.col_ids, cp_.col_ids)
    assert cc.data.dtype == cp_.data.dtype
    tol = (dict(rtol=1e-12, atol=1e-13) if dtype == torch.float64
           else dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(cc.data, cp_.data, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("R,W,kind", [
    (16, 8192, False), (2, 65536, True), (5, 3000, False), (3, 4097, True),
    (2, 5 * 4096 + 7, "rid_edge"), (1, 1 << 18, "one_col"),
    (3, 70001, "one_col"), (1, 1 << 20, True), (9001, 1, False)])
def test_contract_kernel_double_matches_plain(rs, cuda_device, R, W, kind):
    """K1's double variant: the mask exact, the sums within 1e-12 of the
    run prefix's sum of magnitudes (float64 sums in another order), two
    launches bit-identical; rows over many tiles run the look-back over
    the three-word status records."""
    rid, col, val, per_row = contract_rect(rs, R, W, kind)
    val = rs.standard_normal((R, W))
    args, dev_args, last_k, sum_k = contract_on_card(cuda_device, rid, col,
                                                     val, per_row)
    assert sum_k.dtype == torch.float64
    last_p, sum_p = contract.contract_plain(*args, N_COLS)
    assert torch.equal(last_k.cpu(), last_p)
    mag = contract.contract_plain(args[0], args[1], args[2].abs(), N_COLS)[1]
    err = (sum_k.cpu() - sum_p).abs()
    assert bool((err <= 1e-300 + 1e-12 * mag).all()), float(err.max())
    last_2, sum_2 = contract.stream_contract(*dev_args, N_COLS)
    torch.cuda.synchronize()
    assert torch.equal(last_k, last_2)
    assert torch.equal(sum_k.view(torch.int64), sum_2.view(torch.int64))
    assert contract.LAUNCH_SHAPES[(R, W, "row" if per_row else "plane",
                                   "float64")] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("R,W", [(64, 256), (5, 3000), (2, 70000), (4097, 1),
                                 (1, 1 << 20)])
def test_contract_runs_kernel_double_matches_plain(rs, cuda_device, R, W):
    _, col, _ = sorted_rect(rs, R, W, const_rid=True)
    col[0, 0] = -1
    col[-1, -1] = -2
    col, val = torch.from_numpy(col), torch.from_numpy(
        rs.standard_normal((R, W)))
    last_p, sum_p = contract.contract_runs_plain(col, val, N_COLS)
    dcol, dval = col.to(cuda_device), val.to(cuda_device)
    last_k, sum_k = contract.contract_runs(dcol, dval, N_COLS)
    last_2, sum_2 = contract.contract_runs(dcol, dval, N_COLS)
    torch.cuda.synchronize()
    assert contract.RUNS_LAUNCH_SHAPES[(R, W, "float64")] >= 2
    assert torch.equal(last_k.cpu(), last_p)
    mag = contract.contract_runs_plain(col, val.abs(), N_COLS)[1]
    err = (sum_k.cpu() - sum_p).abs()
    assert bool((err <= 1e-300 + 1e-12 * mag).all()), float(err.max())
    assert torch.equal(sum_k.view(torch.int64), sum_2.view(torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sort_rect_two_keys_on_card_equals_plain(rs, cuda_device, dtype):
    """The unpacked two-key chunk sort (pack_bits == 0) through K2 on the
    card: rid, col and values equal to the plain sorts' on the CPU (both
    stable)."""
    from speck_tpu_torch.ops.stream import _sort_rect

    G, W, n_cols = 8, 8192, 1 << 21
    rid = (np.sort(rs.integers(0, 900, (G, W)), 1)
           + 5000 * np.arange(G)[:, None]).astype(np.int32)
    col = rs.integers(0, n_cols, (G, W)).astype(np.int32)
    col[rs.random((G, W)) < 0.1] = n_cols
    val = torch.from_numpy(rs.standard_normal((G, W))).to(dtype)
    args = (torch.from_numpy(rid), torch.from_numpy(col), val)
    n0 = bitonic.LAUNCHES
    got = _sort_rect(*(x.to(cuda_device) for x in args), n_cols, 0)
    torch.cuda.synchronize()
    assert bitonic.LAUNCHES == n0 + 2
    want = _sort_rect(*args, n_cols, 0)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fp64", "fp64_two_phase", "pack_bits0",
                                  "host_analysis_off", "blocked"])
def test_general_stream_on_card_matches_oracle(cuda_device, case):
    """The general stream on the card: float64 (K1 in double), the two-key
    chunk sort, the dense gate counted on the device, row blocks."""
    import scipy.sparse as sp

    dtype, tol = torch.float32, 2e-3
    kw = dict(stream_width=64, product_budget=1 << 12)
    a = b = make_powerlaw(3000, avg=6, seed=3)
    if case.startswith("fp64"):
        dtype, tol = torch.float64, 1e-9
        if case == "fp64_two_phase":
            kw["fused_staging_budget"] = 0
    elif case == "pack_bits0":
        r = np.random.RandomState(41)
        a = pt.HostCSR.from_scipy(sp.random(150, 400, 0.05, format="csr",
                                            random_state=r))
        b = pt.HostCSR.from_scipy(sp.random(400, 131072, 0.002, format="csr",
                                            random_state=r))
        kw = dict(enable_dense=False, stream_width=65536,
                  product_budget=1 << 17)
    elif case == "host_analysis_off":
        kw = dict(host_analysis=False)
    else:
        kw["block_products"] = 1 << 14
    cfg = pt.SpgemmConfig(**kw)
    A = pt.device_put_csr(a, dtype, cuda_device)
    B = A if b is a else pt.device_put_csr(b, dtype, cuda_device)
    n0 = dict(contract.LAUNCH_SHAPES)
    C = pt.spgemm(A, B, cfg)
    Ch = pt.device_get_csr(C)
    assert C.data.dtype == dtype
    new = {k for k, v in contract.LAUNCH_SHAPES.items() if v > n0.get(k, 0)}
    assert new and all(k[3] == str(dtype)[6:] for k in new)
    if case == "pack_bits0":
        assert pt.plan_spgemm(A, B, cfg).stream.pack_bits == 0
    if case == "blocked":
        with pytest.raises(pt.ProductOverflow):
            pt.plan_spgemm(A, B, cfg)
    r = pt.compare_csr(pt.oracle_spgemm(a, b), Ch, compare_data=True,
                       rel_tol=tol)
    assert r.ok, r.message


def _densify_keys(rs, R, L, W):
    """The first densify sort's keys: each row's L sorted entry columns
    (loc * 2, pads at 2 * W) beside W background slots (col * 2 + 1),
    padded to a power of two with INT32_MAX."""
    loc = np.sort(rs.integers(0, W, (R, L)), 1)
    loc[:, L // 2:] = W
    key = np.concatenate([loc * 2, np.broadcast_to(
        np.arange(W) * 2 + 1, (R, W))], 1).astype(np.int32)
    P = 1 << (L + W - 1).bit_length()
    return np.concatenate([key, np.full((R, P - L - W), I32.max, np.int32)],
                          1)


def _rank_keys(rs, R, W, P):
    """A compaction's keys: rank among the present slots, else W + t;
    padded to P with INT32_MAX."""
    last = rs.random((R, W)) < 0.3
    key = np.where(last, np.cumsum(last, 1) - 1, W + np.arange(W))
    return np.concatenate([key, np.full((R, P - W), I32.max)], 1).astype(
        np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("case,R,W,n_pay", [
    # densify on bench config 1 (la = lb = 64, kw = cw = 384): A side,
    # then B side, each a (key, slot) sort and a (rank, slot, hit) sort
    ("densify", 65536, 384, 1), ("densify", 98304, 384, 1),
    # (the tile compaction, columns and values, sorts at the A side's
    # rank shape: cw = 384 padded to 512)
    ("rank", 65536, 384, 2), ("rank", 98304, 384, 2),
    # small windows of the CPU tests
    ("densify", 48, 128, 1), ("rank", 48, 128, 2),
    # the transpose row of bench config 4's P (65536 nonzeros) and of A
    ("transpose", 1, 65536, 2), ("transpose", 1, 2162672, 2)])
def test_sort_kernel_at_the_new_shapes(rs, cuda_device, case, R, W, n_pay):
    """K2 at the shapes the dense tiles, the accumulator's and the tiles'
    compactions and the transpose launch it at, with their key patterns:
    keys and payloads equal to sort_plain's bit for bit."""
    if case == "densify":
        key = _densify_keys(rs, R, 64, W)
    elif case == "rank":
        key = _rank_keys(rs, R, W, 1 << (W - 1).bit_length())
    else:
        P = 1 << (W - 1).bit_length()
        key = np.concatenate([np.sort(rs.integers(0, 16384, W))[
            rs.permutation(W)], np.full(P - W, I32.max)]).astype(
                np.int32)[None, :]
    pays = [np.broadcast_to(np.arange(key.shape[1], dtype=np.int32),
                            key.shape).copy()]
    if n_pay == 2:
        pays.append(special_floats(rs, *key.shape))
    sort_on_card(cuda_device, key, pays)


def _new_route_case(case):
    """(A, B, dtype, config keywords) of one route this slice ported."""
    from speck_tpu_torch.utils.generators import (make_giant_row,
                                                  make_mixed,
                                                  make_prolongation)

    if case == "dense":
        a = make_banded(3000, half_band=16, seed=3)
        return a, a, torch.float32, dict(enable_dia=False)
    if case == "dense_fp64":
        a = make_banded(2000, half_band=8, seed=9)
        return a, a, torch.float64, dict(enable_dia=False)
    if case == "dense_mixed":
        a = make_mixed(4096, 16, 256, 64, seed=13)
        return a, a, torch.float32, dict(enable_dia=False)
    if case == "dense_scatter":
        a = make_banded(3000, half_band=16, seed=3)
        return a, a, torch.float32, dict(enable_dia=False,
                                          dense_densify="scatter")
    if case in ("accum", "accum_fp64"):
        a = make_giant_row(mg=4000, NH=200, HN=400)
        return a, a, (torch.float64 if case == "accum_fp64"
                      else torch.float32), dict(enable_accum=True)
    a = make_banded(4096, half_band=16, seed=3)
    return a, make_prolongation(4096, 1024), torch.float32, {}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense", "dense_fp64", "dense_mixed",
                                  "dense_scatter", "accum", "accum_fp64",
                                  "config4"])
@pytest.mark.parametrize("new_values", [False, True])
def test_new_routes_on_card_match_the_cpu(cuda_device, case, new_values):
    """The dense tiles, the accumulator and config 4's A·P on the card:
    the plan equal to the CPU's, C's structure equal to the CPU's and the
    oracle's, values within 2e-3 (float32) or 1e-9 (float64) of the
    oracle, also for a replay with new values."""
    a, b, dtype, kw = _new_route_case(case)
    tol = 1e-9 if dtype == torch.float64 else 2e-3
    cfg = pt.SpgemmConfig(**kw)
    Ac = pt.device_put_csr(a, dtype, "cpu")
    Bc = Ac if b is a else pt.device_put_csr(b, dtype, "cpu")
    Ag = pt.device_put_csr(a, dtype, cuda_device)
    Bg = Ag if b is a else pt.device_put_csr(b, dtype, cuda_device)
    pc, pg = pt.plan_spgemm(Ac, Bc, cfg), pt.plan_spgemm(Ag, Bg, cfg)
    assert pg.nnz == pc.nnz and pg.max_count == pc.max_count
    assert (pg.dense is None) == (pc.dense is None)
    if case.startswith("dense"):
        assert pg.dense is not None
        assert pg.dense.full_cover == (case != "dense_mixed")
    if case.startswith("accum"):
        assert pg.stream.n_accum == pc.stream.n_accum > 0
    ref_a, ref_b = a, b
    if new_values:
        a2 = pt.HostCSR.from_parts(a.rows, a.cols, a.row_offsets, a.col_ids,
                                   a.data * -2.0 + 0.5)
        b2 = a2 if b is a else b
        Ag2 = pt.device_put_csr(a2, dtype, cuda_device)
        Bg2 = Ag2 if b is a else Bg
        C = pt.device_get_csr(pg.execute(Ag2, Bg2))
        ref_a, ref_b = a2, b2
    else:
        C = pt.device_get_csr(pg.execute())
    _eq = np.testing.assert_array_equal
    if new_values:
        Ac2 = pt.device_put_csr(ref_a, dtype, "cpu")
        Cc = pt.device_get_csr(pc.execute(Ac2, Ac2 if b is a else Bc))
    else:
        Cc = pt.device_get_csr(pc.execute())
    _eq(C.row_offsets, Cc.row_offsets)
    _eq(C.col_ids, Cc.col_ids)
    r = pt.compare_csr(pt.oracle_spgemm(ref_a, ref_b), C, compare_data=True,
                       rel_tol=tol)
    assert r.ok, r.message


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transpose_and_galerkin_on_card(cuda_device, dtype):
    """transpose(P) on the card equals scipy's P.T exactly (one K2
    launch); Pᵀ·(A·P) on the card matches scipy's."""
    import scipy.sparse as sp

    from speck_tpu_torch.utils.generators import make_prolongation

    a, p = make_banded(4096, half_band=16, seed=3), make_prolongation(4096,
                                                                      1024)
    A = pt.device_put_csr(a, dtype, cuda_device)
    P = pt.device_put_csr(p, dtype, cuda_device)
    n0 = bitonic.LAUNCH_SHAPES.get((1, 4096, 2), 0)
    PT = pt.transpose(P)
    torch.cuda.synchronize()
    assert bitonic.LAUNCH_SHAPES[(1, 4096, 2)] == n0 + 1
    ref = p.to_scipy().T.tocsr()
    ref.sort_indices()
    got = pt.device_get_csr(PT)
    np.testing.assert_array_equal(got.row_offsets, ref.indptr)
    np.testing.assert_array_equal(got.col_ids, ref.indices)
    np.testing.assert_array_equal(got.data, ref.data.astype(got.data.dtype))
    G = pt.device_get_csr(pt.spgemm(PT, pt.spgemm(A, P)))
    g = (ref @ (a.to_scipy() @ p.to_scipy())).tocsr()
    g.sort_indices()
    r = pt.compare_csr(pt.HostCSR.from_scipy(g), G, compare_data=True,
                       rel_tol=1e-9 if dtype == torch.float64 else 2e-3)
    assert r.ok, r.message


def _mesh_input(case):
    """Small mesh inputs: a power-law matrix (the stream with a wide row)
    and a random one with a row past a lowered k-split threshold."""
    import scipy.sparse as sp

    if case == "powerlaw":
        return make_powerlaw(4096, avg=6, seed=3), {}
    rs_ = np.random.RandomState(33)
    base = sp.random(240, 240, 0.08, format="csr", random_state=rs_)
    base.data = rs_.standard_normal(base.nnz)
    lil = base.tolil()
    lil[17, :] = rs_.standard_normal(240)
    return (pt.HostCSR.from_scipy(lil.tocsr()),
            dict(stream_width=64, product_budget=1 << 14,
                 mesh_split_min_ops=900))


def _mesh_card_vs_cpu(h, cfg, exchange, dtype):
    """mesh_stream_spgemm with four shards on one card against the same
    call with four CPU shards: meta and nnz_row equal, each shard's
    columns equal within its counts, values within rtol 2e-3 (float32) or
    1e-12 (float64), every output on the card, the result against the
    oracle. Returns the card's meta and the K1 and K2 launches of the
    card's call."""
    from speck_tpu_torch.parallel import (make_row_mesh, mesh_stream_spgemm,
                                          mesh_stream_to_host_csr)
    from speck_tpu_torch.parallel.dist import fetch_output

    k1, k2 = contract.LAUNCHES, bitonic.LAUNCHES
    got = mesh_stream_spgemm(h, h, make_row_mesh(4, devices=["cuda:0"]),
                             cfg, exchange=exchange, dtype=dtype)
    torch.cuda.synchronize()
    launches = (contract.LAUNCHES - k1, bitonic.LAUNCHES - k2)
    assert all(x.device.type == "cuda" for x in got[:3])
    want = mesh_stream_spgemm(h, h, make_row_mesh(4, devices=["cpu"]), cfg,
                              exchange=exchange, dtype=dtype)
    gm, wm = got[3], want[3]
    for k in ("ranges", "m_loc", "out_cap", "shape", "route", "ksplit"):
        assert gm[k] == wm[k], k
    gs, ws = gm["stats"], wm["stats"]
    assert (gs is None) == (ws is None)
    if gs is not None:
        assert (gs.mode, gs.needset_bytes, gs.allgather_bytes) == \
            (ws.mode, ws.needset_bytes, ws.allgather_bytes)
    gn = fetch_output(got[0]).reshape(4, -1)
    np.testing.assert_array_equal(gn, fetch_output(want[0]).reshape(4, -1))
    gc, wc = (fetch_output(x[1]).reshape(4, -1) for x in (got, want))
    gv, wv = (fetch_output(x[2]).reshape(4, -1) for x in (got, want))
    tol = 2e-3 if dtype == torch.float32 else 1e-12
    for d in range(4):
        tot = int(gn[d].sum())
        np.testing.assert_array_equal(gc[d, :tot], wc[d, :tot])
        np.testing.assert_allclose(gv[d, :tot], wv[d, :tot], rtol=tol,
                                   atol=tol * 1e-2)
    r = pt.compare_csr(pt.oracle_spgemm(h, h), mesh_stream_to_host_csr(*got),
                       compare_data=True,
                       rel_tol=2e-3 if dtype == torch.float32 else 1e-9)
    assert r.ok, r.message
    return gm, launches


@pytest.mark.gpu
@pytest.mark.parametrize("exchange", ["allgather", "needset"])
@pytest.mark.parametrize("case", ["powerlaw", "ksplit"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_on_card_matches_the_cpu(cuda_device, exchange, case, dtype):
    """The stream mesh with four shards on one card against the same call
    with four CPU shards (``_mesh_card_vs_cpu``); K1 and K2 launched."""
    h, kw = _mesh_input(case)
    meta, (k1, k2) = _mesh_card_vs_cpu(h, pt.SpgemmConfig(**kw), exchange,
                                       dtype)
    assert k1 > 0 and k2 > 0
    assert (meta["ksplit"] is not None) == (case == "ksplit")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sdia", "dense", "dense_scatter",
                                  "overlap", "overlap_ksplit"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_routes_on_card_match_the_cpu(cuda_device, case, dtype):
    """The mesh's diagonal-plane route (a band), dense route (a band with
    the diagonal planes off, under allgather; both densify forms) and
    overlapped need-set exchange (the power-law input, and the k-split
    one) with four shards on one card against four CPU shards: the dense
    and overlapped routes launch K2, the overlapped one K1."""
    if case == "sdia":
        h, kw, exchange = make_banded(4096, half_band=8, seed=3), {}, \
            "needset"
    elif case.startswith("dense"):
        h, exchange = make_banded(4096, half_band=16, seed=3), "allgather"
        kw = dict(enable_sdia=False)
        if case == "dense_scatter":
            kw["dense_densify"] = "scatter"
    else:
        h, kw = _mesh_input("powerlaw" if case == "overlap" else "ksplit")
        kw = dict(kw, mesh_exchange_auto=False)
        exchange = "needset_overlap"
    meta, (k1, k2) = _mesh_card_vs_cpu(h, pt.SpgemmConfig(**kw), exchange,
                                       dtype)
    route = {"sdia": "sdia", "dense": "dense", "dense_scatter": "dense"}
    assert meta["route"] == route.get(case, "stream")
    mode = {"sdia": "dia_halo", "dense": "dense_allgather",
            "dense_scatter": "dense_allgather"}
    assert meta["stats"].mode == mode.get(case, "needset_overlap")
    if case == "dense":
        assert k2 > 0
    if case.startswith("overlap"):
        assert k1 > 0 and k2 > 0


@pytest.mark.gpu
def test_ppermute_start_across_cards():
    """A permute round between two cards of one process runs on the cards'
    copy streams: wait() gives each shard its neighbour's part, equal to
    what was sent, after work queued behind it on the receiving card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from speck_tpu_torch.parallel import make_row_mesh
    from speck_tpu_torch.parallel.dist import ppermute_start

    mesh = make_row_mesh(2, devices=["cuda:0", "cuda:1"])
    parts = {d: torch.arange(1 << 20, dtype=torch.int32,
                             device=mesh.devices[d]) * (d + 1)
             for d in mesh.local}
    rnd = ppermute_start(mesh, parts, 1)
    for d in mesh.local:
        got = rnd.wait(d)
        assert got.device == mesh.devices[d]
        src = (d - 1) % 2
        assert torch.equal(got.cpu(), parts[src].cpu())


@pytest.mark.gpu
def test_mesh_fixed_cap_on_card(cuda_device):
    """mesh_spgemm_fixed_cap with four shards on one card: K2 and K3
    launched, the result equal in structure to the oracle's."""
    from speck_tpu_torch.parallel import (make_row_mesh,
                                          mesh_spgemm_fixed_cap)

    h = make_banded(4096, half_band=4, seed=3)
    k2, k3 = bitonic.LAUNCHES, contract.RUNS_LAUNCHES
    out = mesh_spgemm_fixed_cap(h, h, make_row_mesh(4, devices=["cuda:0"]))
    torch.cuda.synchronize()
    assert bitonic.LAUNCHES > k2 and contract.RUNS_LAUNCHES > k3
    C = padded_to_host_csr(*out, h.rows, h.cols)
    r = pt.compare_csr(pt.oracle_spgemm(h, h), C, compare_data=True,
                       rel_tol=2e-3)
    assert r.ok, r.message


# ---------------------------------------------------------------------------
# 16-bit values, K2 at widths that are not powers of two, the A/B knobs
# ---------------------------------------------------------------------------

HALF_TYPES = [torch.bfloat16, torch.float16]
# unit roundoff and half the smallest subnormal (utils/compare.py)
_U = {torch.bfloat16: (2.0 ** -8, 2.0 ** -134),
      torch.float16: (2.0 ** -11, 2.0 ** -25)}


def _within_half_bound(got, ref, mag, n, dtype):
    """|got - ref| <= 2 (n + 1) (u mag + eta): the 16-bit bound of
    utils/compare.compare_csr_bound for sums of n terms of magnitude
    sum mag."""
    u, eta = _U[dtype]
    err = (got.double() - ref.double()).abs()
    return bool((err <= 2 * (n.double() + 1) * (u * mag.double() + eta)
                 ).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_TYPES)
@pytest.mark.parametrize("R,W,kind", [(16, 8192, False), (2, 65536, True),
                                      (5, 3000, False), (3, 4097, True),
                                      (1, 1 << 20, True)])
def test_contract_kernel_16bit_matches_plain(rs, cuda_device, dtype, R, W,
                                             kind):
    """K1 in bfloat16 and float16: masks equal, the sums (taken in float
    and rounded once, by the kernel and by the plain version alike) within
    the 16-bit bound of the run's terms."""
    rid, col, val, per_row = contract_rect(rs, R, W, kind)
    args = [torch.from_numpy(rid), torch.from_numpy(col),
            torch.from_numpy(val).to(dtype)]
    dev_args = [x.to(cuda_device) for x in args]
    if per_row:
        dev_args[0] = dev_args[0][:, 0].contiguous().as_strided((R, W),
                                                                (1, 0))
    n0 = contract.LAUNCHES
    last_k, sum_k = contract.stream_contract(*dev_args, N_COLS)
    torch.cuda.synchronize()
    assert contract.LAUNCHES == n0 + 1 and sum_k.dtype == dtype
    last_p, sum_p = contract.contract_plain(*args, N_COLS)
    assert torch.equal(last_k.cpu(), last_p)
    mag = contract.contract_plain(args[0], args[1],
                                  args[2].float().abs(), N_COLS)[1]
    cnt = contract.contract_plain(args[0], args[1],
                                  torch.ones(R, W), N_COLS)[1]
    assert _within_half_bound(sum_k.cpu(), sum_p, mag, cnt, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF_TYPES)
@pytest.mark.parametrize("R,W", [(64, 256), (32, 2048), (5, 3000),
                                 (2, 70000)])
def test_contract_runs_kernel_16bit_matches_plain(rs, cuda_device, dtype,
                                                  R, W):
    """K3 in bfloat16 and float16, as K1's 16-bit test."""
    col = np.sort(rs.integers(0, N_COLS, (R, W)), 1).astype(np.int32)
    col[:, W - W // 4:] = N_COLS
    col, val = torch.from_numpy(col), torch.from_numpy(
        rs.standard_normal((R, W)).astype(np.float32)).to(dtype)
    n0 = contract.RUNS_LAUNCHES
    last_k, sum_k = contract.contract_runs(col.to(cuda_device),
                                           val.to(cuda_device), N_COLS)
    torch.cuda.synchronize()
    assert contract.RUNS_LAUNCHES == n0 + 1 and sum_k.dtype == dtype
    last_p, sum_p = contract.contract_runs_plain(col, val, N_COLS)
    assert torch.equal(last_k.cpu(), last_p)
    mag = contract.contract_runs_plain(col, val.float().abs(), N_COLS)[1]
    cnt = contract.contract_runs_plain(col, torch.ones(R, W), N_COLS)[1]
    assert _within_half_bound(sum_k.cpu(), sum_p, mag, cnt, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("R,W,n_pay", [(4, 3 * 8192, 1), (4, 3 * 8192, 3),
                                       (1, 3 * 65536, 2), (1, 3 * 65536, 1),
                                       (3, 1000, 2)])
def test_sort_kernel_at_widths_not_powers_of_two(rs, cuda_device, R, W,
                                                 n_pay):
    """K2 padded to the next power of two: keys and payloads equal to the
    stable plain sort's, bit for bit, with INT32_MAX keys among the real
    ones (the pad must stay behind them)."""
    key = rs.integers(0, 1 << 20, (R, W)).astype(np.int32)
    key[:, ::7] = bitonic.INT32_MAX
    pays = [rs.integers(-2 ** 31, 2 ** 31 - 1, (R, W)).astype(np.int32)
            for _ in range(n_pay)]
    sort_on_card(cuda_device, key, pays)
    assert (R, W, n_pay) in bitonic.LAUNCH_SHAPES


@pytest.mark.gpu
@pytest.mark.parametrize("S,rows", [(2048, 32768), (2048, 3), (5, 1000)])
def test_sublane_gather_kernel_equals_torch_gather(rs, cuda_device, S, rows):
    """The redesigned sublane_gather equals torch.gather exactly."""
    tab = torch.from_numpy(rs.standard_normal((S, 128)).astype(np.float32)
                           ).to(cuda_device)
    idx = torch.from_numpy(rs.integers(0, S, (rows, 128)).astype(np.int32)
                           ).to(cuda_device)
    got = gm.sublane_gather(idx, tab)
    assert torch.equal(got, torch.gather(tab, 0, idx.long()))


@pytest.mark.gpu
@pytest.mark.parametrize("knob", [dict(stream_compact_impl="scatter"),
                                  dict(stream_expand_impl="decode"),
                                  dict(stream_sort_impl="bitonic"),
                                  dict(stream_level_factor=3),
                                  dict(dtype=torch.bfloat16),
                                  dict(dtype=torch.float16)])
def test_knobs_and_types_on_card_match_the_cpu(cuda_device, knob):
    """Each knob's spgemm (wide rows, the ladder at W = 64) and each 16-bit
    type on the card: structure equal to the CPU's, values within the
    float32 tolerance or the 16-bit bound of the oracle."""
    from speck_tpu_torch.utils.compare import compare_csr_bound

    knob = dict(knob)
    dtype = knob.pop("dtype", torch.float32)
    h = make_powerlaw(3000, avg=6, seed=3)
    cfg = pt.SpgemmConfig(stream_width=64, product_budget=1 << 12,
                          stream_max_width=256, **knob)
    outs = []
    for dev in ("cpu", cuda_device):
        A = pt.device_put_csr(h, dtype, dev)
        C = pt.spgemm(A, A, cfg)
        assert C.data.dtype == dtype
        outs.append(pt.device_get_csr(C))
    assert pt.compare_csr(outs[0], outs[1]).ok
    if dtype == torch.float32:
        r = pt.compare_csr(pt.oracle_spgemm(h, h), outs[1],
                           compare_data=True, rel_tol=2e-3)
    else:
        hr = pt.HostCSR(rows=h.rows, cols=h.cols, row_offsets=h.row_offsets,
                        col_ids=h.col_ids, data=torch.as_tensor(
                            h.data).to(dtype).double().numpy())
        r = compare_csr_bound(hr, hr, outs[1], dtype)
    assert r.ok, r.message


@pytest.mark.gpu
@pytest.mark.parametrize("name", [n for n, _ in cf.ANALYSIS_CASES])
def test_device_analysis_exact_on_the_card(cuda_device, name):
    """Past 2^24 products the device analysis and the routing gate are
    exact on the card as on the CPU: every row's count, the total, the
    gate's saturated total and widest row (ROADMAP.md Queue 3 item 14: a
    float32 cumulative sum and float32 totals rounded, each device in its
    own order; 968 of the band's rows were off on the card)."""
    h = dict(cf.ANALYSIS_CASES)[name]()
    assert cf.run_analysis_case(h, cuda_device) is None
    assert cf.run_analysis_case(h, "cpu") is None


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(-len(cf.FIXED), 0))
def test_conformance_fixed_cases_on_the_card(cuda_device, seed):
    """Each hand-built case of the conformance sweep (one or more a route)
    twice on the card and once on the CPU: plan fields equal, structure
    bit for bit, values within the sum-order bound and the oracle, the two
    card runs bit-identical but for the accumulator's values (standing
    decision 13)."""
    c = cf.case(seed)
    runs = [cf.run_case(c, cuda_device) for _ in range(2)]
    v = cf.check(c, runs, cf.run_case(c, "cpu"))
    assert not v.failures, (c.describe(), v.failures)
    assert v.deterministic or v.routes & cf.NONDETERMINISTIC_ROUTES


@pytest.mark.gpu
@pytest.mark.parametrize("backend,procs", [("gloo", 2), (None, 2)])
def test_multihost_launcher_on_the_card(cuda_device, backend, procs):
    """multihost_spgemm in two worker processes on the card
    (probes/multihost_cards.py) at the two-process CPU test's sizes: under
    gloo, on a machine of one card, both share cuda:0 (card tensors cross
    through the host); under the port's own choice (``backend=None``)
    each process takes a card of its own and NCCL, which needs two cards.
    Under either backend a process takes the card LOCAL_RANK modulo the
    cards. Every case against the scipy oracle and the one-process mesh
    over the same 4 shards on cuda:0, as on the CPU
    (``tests/test_torch_multihost_launch.py``), with K1 and K2 launched in
    the workers."""
    from test_torch_multihost_launch import launch_cases

    from speck_tpu_torch.probes import multihost_cards as mc

    if backend is None and torch.cuda.device_count() < procs:
        pytest.skip(f"NCCL takes a card a process: {procs} cards needed, "
                    f"{torch.cuda.device_count()} present")
    cases, matrices = launch_cases()
    rep = mc.run(cases, matrices, procs=procs, backend=backend,
                 device="cuda", timeout=300, log=lambda line: None)
    assert rep["backend"] == (backend or "nccl")
    # a process takes the card LOCAL_RANK modulo the cards, whatever the
    # backend: two processes share cuda:0 on a card of one
    n_cards = torch.cuda.device_count()
    assert [r["device"] for r in rep["ranks"]] == [
        f"cuda:{r % n_cards}" for r in range(procs)]
    assert set(rep["cases"]) == {c.name for c in cases}
    assert sum(rep["k1"].values()) > 0 and sum(rep["k2"].values()) > 0


def _sync_case(case, device):
    """(the call, its operand) of one entry of the sync check."""
    from speck_tpu_torch.utils.generators import make_stencil27

    wide = dict(stream_width=64, product_budget=1 << 12)
    if case == "stencil":
        # past host_analysis_max_nnz: the lite gate, the device analysis
        h, dtype, kw = (make_stencil27(12, seed=19), torch.float64,
                        dict(host_analysis_max_nnz=16))
    elif case == "dia":
        h, dtype, kw = make_banded(3000, half_band=4, seed=3), torch.float32, {}
    else:
        h, dtype = make_powerlaw(3000, avg=6, seed=3), torch.float32
        kw = {"levels": dict(wide, stream_max_width=64),
              "two_phase": dict(wide, fused_staging_budget=0),
              "execute": dict(wide, fused_staging_budget=0),
              "blocked": dict(wide, block_products=1 << 15)}[case]
    A = pt.device_put_csr(h, dtype, device)
    cfg = pt.SpgemmConfig(**kw)
    if case == "execute":
        plan = pt.plan_spgemm(A, A, cfg)
        A2 = pt.device_put_csr(h, dtype, device)
        return lambda: plan.execute(A2, A2)
    return lambda: pt.spgemm(A, A, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["levels", "two_phase", "execute",
                                  "stencil", "dia", "blocked"])
def test_readbacks_are_every_sync_of_a_call(cuda_device, case):
    """One call under ``torch.cuda.set_sync_debug_mode("warn")``: the
    synchronizing operations torch reports are the readbacks the program
    counted (``utils.timings.READBACKS``), one for one; host arrays reach
    the card without one (``upload``)."""
    import traceback
    import warnings

    from speck_tpu_torch.utils import timings as tt

    call = _sync_case(case, cuda_device)
    call()
    torch.cuda.synchronize()
    # torch reports one synchronize of its own at a process's first
    # switch of the mode
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    before = sum(n for n, _ in tt.READBACKS.values())
    syncs = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            syncs.append("".join(traceback.format_stack(limit=8)[:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            C = call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counted = sum(n for n, _ in tt.READBACKS.values()) - before
    assert len(syncs) == counted, "\n----\n".join(
        s for s in syncs if "timings.py" not in s)
    assert C.nnz > 0 and (counted == 0) == (case == "execute")


@pytest.mark.gpu
def test_live_slots_on_the_card(cuda_device):
    """The counting pass's chunk launches carry the stream's products
    (scipy's, less the direct rows'), beside launch counts that stay as
    they were; the wide rows' launches carry their entries."""
    import scipy.sparse as sps

    h = make_powerlaw(3000, avg=6, seed=3)
    A = pt.device_put_csr(h, torch.float32, cuda_device)
    cfg = pt.SpgemmConfig(stream_width=64, product_budget=1 << 12,
                          enable_direct=False, enable_dense=False,
                          enable_accum=False, enable_dia=False,
                          enable_sdia=False, dia_rows=False)
    pt.plan_spgemm(A, A, cfg)
    k1 = {k: list(v) for k, v in contract.LAUNCH_LIVE.items()}
    shapes = dict(contract.LAUNCH_SHAPES)
    plan = pt.plan_spgemm(A, A, cfg)
    mat = sps.csr_matrix((h.data, h.col_ids, h.row_offsets),
                         shape=(h.rows, h.cols))
    lens = np.diff(mat.indptr)
    products = int(lens[mat.indices].sum())
    assert plan.stream.products == products
    new = {k: [v[0] - k1.get(k, [0, 0])[0], v[1] - k1.get(k, [0, 0])[1]]
           for k, v in contract.LAUNCH_LIVE.items()}
    plane = sum(v[1] for k, v in new.items() if k[2] == "plane")
    assert plane == products
    for k, (n, live) in new.items():
        # every launch of a shape carried a count, within its slots
        assert n == contract.LAUNCH_SHAPES[k] - shapes.get(k, 0)
        assert 0 <= live <= n * k[0] * k[1]
    assert all(v[1] <= v[0] * k[0] * k[1]
               for k, v in bitonic.LAUNCH_LIVE.items())


def _k4_csr(rs, rows, cols, shape):
    import scipy.sparse as sp

    mat = sp.csr_matrix((rs.standard_normal(len(rows)), (rows, cols)),
                        shape=shape)
    mat.sum_duplicates()
    return pt.HostCSR.from_scipy(mat)


def _k4_rows(rs, m, n, avg, first=0, col0=0):
    """Rows first .. first + m of 1 to 2 * avg - 1 random columns in
    [col0, col0 + n): (row ids, column ids)."""
    lens = rs.integers(1, 2 * avg, m)
    return (first + np.repeat(np.arange(m), lens),
            col0 + rs.integers(0, n, int(lens.sum())))


def _k4_short(rs):
    # 20000 rows of ~3: ~60k records, several times a chunk's window
    r, c = _k4_rows(rs, 20000, 20000, 3)
    return _k4_csr(rs, r, c, (20000, 20000)), None


def _k4_small(rs):
    # 1000 rows of ~6: every record inside one window (uncompacted)
    r, c = _k4_rows(rs, 1000, 1000, 6)
    return _k4_csr(rs, r, c, (1000, 1000)), None


def _k4_long_b(rs):
    # B rows of 60 entries, A rows of 1-15: wide rows of 1-4 rectangle
    # rows, so that chunk starts fall inside rows and records
    r, c = _k4_rows(rs, 1000, 500, 8)
    a = _k4_csr(rs, r, c, (1000, 500))
    rb = np.repeat(np.arange(500), 60)
    return a, _k4_csr(rs, rb, rs.integers(0, 4000, rb.shape[0]),
                      (500, 4000))


def _k4_empty_tail(rs):
    # 600 rows of ~5, then 3000 rows without entries (rows that end the
    # stream at one start)
    r, c = _k4_rows(rs, 600, 600, 5)
    return _k4_csr(rs, r, c, (3600, 3600)), None


def _k4_heavy(rs):
    # 1000 rows of ~6 and 20 of ~40 (past accum_min_ops = 64 products)
    r1, c1 = _k4_rows(rs, 1000, 1020, 6)
    r2, c2 = _k4_rows(rs, 20, 1020, 40, first=1000)
    return _k4_csr(rs, np.concatenate([r1, r2]), np.concatenate([c1, c2]),
                   (1020, 1020)), None


def _k4_zero_records(rs):
    # A's row 0 holds 3000 entries on empty B rows and 10 on full ones,
    # rows 1-399 ~5 on full ones; B's rows 4000-4999 hold 20 entries:
    # 7000 records in one window (uncompacted), 3000 of them at one start
    r, c = _k4_rows(rs, 399, 1000, 5, first=1, col0=4000)
    r = np.concatenate([np.zeros(3010, np.int64), r])
    c = np.concatenate([np.arange(3000), 4000 + np.arange(10), c])
    rb = np.repeat(np.arange(4000, 5000), 20)
    return (_k4_csr(rs, r, c, (5000, 5000)),
            _k4_csr(rs, rb, rs.integers(0, 5000, rb.shape[0]),
                    (5000, 5000)))


# K4's cases, each a chunk of a plan of the stream route: (matrices, G, W,
# SpgemmConfig keywords beyond expand_profile.STREAM_ONLY, which chunk:
# "first", "mid", "last", "inside" (the first after chunk 0 whose start
# lies strictly inside a record) or "zero" (the one holding the start of
# the 3000 records without products), slots the stream is moved by)
K4_CASES = {
    # a full chunk whose records are read from a window of nnz_a
    "window_cut": (_k4_short, 16, 512, {}, "mid", 0),
    # a stream whose records a window holds all of
    "window_all": (_k4_small, 16, 512, {}, "first", 0),
    # chunk 0 over a cut window: sid_base 0
    "sid_base_0": (_k4_short, 16, 512, {}, "first", 0),
    "inside_record": (_k4_long_b, 8, 256, {}, "inside", 0),
    # the short last chunk, slots past every row, past 2048 equal row
    # starts (the rows without products at the stream's end)
    "past_rows": (_k4_empty_tail, 16, 256, {}, "last", 0),
    # slots before the first row (rid -1): a plan's stream moved 5 slots
    # on, which no plan lays out
    "lead": (_k4_small, 16, 512, {}, "first", 5),
    # behind the accumulator's rows (e = -1)
    "accum_rows": (_k4_heavy, 8, 512,
                   dict(enable_accum=True, accum_min_ops=64), "first", 0),
    # uncompacted records, 3000 of them without products at one start:
    # past 2048 equal record starts in a tile
    "uncompacted": (_k4_zero_records, 16, 512, {}, "zero", 0),
}
K4_VALUES = {"float32": ("float32", "float32"),
             "float64": ("float64", "float64"),
             "bfloat16": ("bfloat16", "bfloat16"),
             "float16": ("float16", "float16"),
             "bf16_x_f32": ("bfloat16", "float32"),
             "f16_x_bf16": ("float16", "bfloat16"),
             "f16_x_f64": ("float16", "float64")}


def _k4_moved(args, lead):
    """``expand_args``' chunk 0 with the stream moved ``lead`` slots on:
    row starts (not the accumulator's -1), record starts and ends (not
    the INT32_MAX tail's) and B's offsets (su = B's start - p0)."""
    e, p0, su, sa, pend = args[:5]
    real = p0 != 2 ** 31 - 1
    return ((torch.where(e >= 0, e + lead, e),
             torch.where(real, p0 + lead, p0),
             torch.where(real, su - lead, su), sa,
             torch.where(real, pend + lead, pend)) + args[5:7]
            + (torch.zeros((), dtype=torch.int32, device=e.device),)
            + args[8:])


def _k4_chunk(case, value, device):
    """The arguments of ``stream_expand`` for one K4 case, with the
    property the case names asserted."""
    from speck_tpu_torch.probes.expand_profile import (expand_args,
                                                        stream_plan)

    make, G, W, kw, which, lead = K4_CASES[case]
    ha, hb = make(np.random.default_rng([20261018, G, W]))
    dta, dtb = (getattr(torch, t) for t in K4_VALUES[value])
    A = pt.device_put_csr(ha, dta, device)
    B = pt.device_put_csr(ha if hb is None else hb, dtb, device)
    plan = stream_plan(A, B, stream_width=W, product_budget=G * W, **kw)
    lo = plan.stream.layout
    assert (lo.G, lo.W) == (G, W)
    n = lo.n_chunks
    rec = plan.stream.rec
    p0 = rec.p0.cpu().numpy()
    pend = rec.pend.cpu().numpy()
    sid = rec.sid_bases.cpu().numpy()
    e = plan.stream.e.cpu().numpy()
    nnz_a, CP = p0.shape[0], G * W
    if which == "inside":
        c = next(c for c in range(1, n) if sid[c] > 0
                 and p0[sid[c] - 1] < c * CP < pend[sid[c] - 1])
    elif which == "zero":
        start = np.bincount(p0[p0 < 2 ** 31 - 1]).argmax()
        c = int(start) // CP
    else:
        c = {"first": 0, "mid": n // 2, "last": n - 1}[which]
    args = expand_args(plan, c)
    if case in ("window_cut", "sid_base_0"):
        assert nnz_a > CP + 2
    if case in ("window_all", "uncompacted"):
        assert nnz_a <= CP + 2
    if case == "sid_base_0":
        assert sid[c] == 0
    if case == "past_rows":
        Gc = args[8]
        assert Gc < G and c * CP + Gc * W > lo.total_q
        assert (e == lo.total_q).sum() > 2048
    if case == "accum_rows":
        assert (e == -1).sum() > 0
    if case == "uncompacted":
        assert np.bincount(p0[p0 < 2 ** 31 - 1]).max() > 2048
    if lead:
        args = _k4_moved(args, lead)
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("value", list(K4_VALUES))
@pytest.mark.parametrize("case", list(K4_CASES))
def test_expand_kernel_matches_plain(cuda_device, case, value):
    """K4 against expand_plain on the card: rid, col and val equal bit for
    bit (types included, dead slots too), one launch counted by shape."""
    from speck_tpu_torch.ops import expand
    from speck_tpu_torch.probes.expand_profile import planes_equal

    args = _k4_chunk(case, value, cuda_device)
    n0, shapes = expand.LAUNCHES, dict(expand.LAUNCH_SHAPES)
    got = expand.stream_expand(*args)
    torch.cuda.synchronize()
    assert expand.LAUNCHES == n0 + 1
    G, W = args[8], args[9]
    kind = "packed" if value == "float32" else "unpacked"
    key = (G, W, kind, str(got[2].dtype).replace("torch.", ""))
    assert expand.LAUNCH_SHAPES[key] == shapes.get(key, 0) + 1
    assert planes_equal(got, expand.expand_plain(*args))
    if case == "lead":
        assert bool((got[0][0, :5] == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("value", ["float32", "float64", "bfloat16"])
def test_expand_kernel_is_deterministic(cuda_device, value):
    """Two K4 launches on the (512, 8192) chunk of expand_profile's case
    of the value type give the same bits."""
    from speck_tpu_torch.ops import expand
    from speck_tpu_torch.probes import expand_profile as xp

    c = xp.case(value, dict(xp.CASES)[value], cuda_device)
    a = expand.stream_expand(*c.args)
    b = expand.stream_expand(*c.args)
    torch.cuda.synchronize()
    assert xp.planes_equal(a, b)
    assert xp.planes_equal(a, expand.expand_plain(*c.args))


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["contiguous", "dtype", "device",
                                  "record", "sid_base"])
def test_expand_kernel_rejects_what_it_does_not_take(cuda_device, what):
    """The wrapper raises ValueError for a non-contiguous plane, a wrong
    type, an operand on another device, a record of another shape and a
    sid_base that is no int32 device scalar."""
    from speck_tpu_torch.ops import expand

    args = list(_k4_chunk("window_all", "float32", cuda_device))
    if what == "contiguous":
        args[1] = torch.stack([args[1], args[1]], 1)[:, 0]
    elif what == "dtype":
        args[2] = args[2].long()
    elif what == "device":
        args[3] = args[3].cpu()
    elif what == "record":
        args[5] = torch.cat([args[5], args[5][:, :1]], 1)
    else:
        args[7] = args[7].long()
    n0 = expand.LAUNCHES
    with pytest.raises(ValueError):
        expand.stream_expand(*args)
    assert expand.LAUNCHES == n0


@pytest.mark.gpu
def test_expand_launches_a_chunk_on_the_card(cuda_device):
    """A plan's counting pass launches K4 once a chunk, carrying the
    stream's products as its live slots; the numeric pass of
    ``execute`` with new values once a chunk again."""
    from speck_tpu_torch.ops import expand

    h = make_powerlaw(3000, avg=6, seed=3)
    A = pt.device_put_csr(h, torch.float32, cuda_device)
    cfg = pt.SpgemmConfig(stream_width=64, product_budget=1 << 12,
                          enable_direct=False, enable_dense=False,
                          enable_accum=False, enable_dia=False,
                          enable_sdia=False, dia_rows=False,
                          fused_staging_budget=0)
    n0, live0 = expand.LAUNCHES, {k: list(v) for k, v in
                                  expand.LAUNCH_LIVE.items()}
    plan = pt.plan_spgemm(A, A, cfg)
    chunks = plan.stream.layout.n_chunks
    assert chunks > 1 and expand.LAUNCHES == n0 + chunks
    live = sum(v[1] - live0.get(k, [0, 0])[1]
               for k, v in expand.LAUNCH_LIVE.items())
    assert live == plan.stream.products
    n1 = expand.LAUNCHES
    plan.execute(pt.device_put_csr(h, torch.float32, cuda_device),
                 pt.device_put_csr(h, torch.float32, cuda_device))
    torch.cuda.synchronize()
    assert expand.LAUNCHES == n1 + chunks
