"""The port's two kernels against the JAX package's Pallas kernels.

K1 (ops/contract.py, replaces pallas_kernels.stream_contract_runs) and K2
(ops/bitonic.py, replaces bitonic.bitonic_sort_pairs_pallas). On the CPU
the wrappers run their plain torch versions; those are held to the JAX
forms (Pallas in interpret mode and the XLA forms): the contract
bit-identically (rtol 0, same doubling order), the sort with equal keys
and equal per-row (key, payload) multisets (the JAX network is not
stable; the port's sort is, and equals numpy's stable argsort). K2's
launch plan (tile, merge passes, scratch) is host code and is tested
here. K4 (ops/expand.py, the stream chunk's expand, which replaces no
Pallas kernel): its wrapper takes the plain version on the CPU, which
test_torch_stream.py holds to the JAX expand. The CUDA kernels against
the plain versions are in test_torch_gpu.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from speck_tpu.ops import bitonic as jbitonic
from speck_tpu.ops.pallas_kernels import stream_contract_runs
from speck_tpu.ops.stream import _contract_rect
import speck_tpu_torch as pt
from speck_tpu_torch.ops import bitonic, contract, expand
from speck_tpu_torch.probes.expand_profile import (expand_args, planes_equal,
                                                    stream_plan)
from speck_tpu_torch.utils.generators import make_powerlaw

N_COLS = 300


def _expand_plan(value=("float32", "float32")):
    """A plan of the stream route over (8, 256) chunks, A in value[0] and
    B (A's matrix) in value[1], on the CPU: the expand's operands as the
    planner lays them out."""
    h = make_powerlaw(3000, 6, 2.2, 3)
    A, B = (pt.device_put_csr(h, getattr(torch, t), "cpu") for t in value)
    return stream_plan(A, B, stream_width=256, product_budget=1 << 11)


def _sorted_rect(rng, R, W, const_rid=False):
    """(rid, col, val) rows sorted by (rid, col) with duplicate runs and
    dead slots (col == N_COLS) at each row's end."""
    rid = np.zeros((R, W), np.int32)
    col = np.full((R, W), N_COLS, np.int32)
    for r in range(R):
        live = int(rng.integers(W // 2, W + 1))
        if const_rid:
            rid[r] = 7 + r
            c = np.sort(rng.integers(0, N_COLS, live))
        else:
            rr = np.sort(rng.integers(0, 6, live))
            c = rng.integers(0, 40, live)
            order = np.lexsort((c, rr))
            rr, c = rr[order], c[order]
            rid[r, :live] = rr
            rid[r, live:] = rr[-1] if live else 0
        col[r, :live] = c
    val = rng.standard_normal((R, W)).astype(np.float32)
    return rid, col, val


@pytest.mark.parametrize("R,W,const_rid", [(64, 512, False),
                                           (2, 16384, True)])
def test_contract_plain_bit_identical_to_jax(rng, R, W, const_rid):
    rid, col, val = _sorted_rect(rng, R, W, const_rid)
    last_t, sum_t = contract.stream_contract(
        torch.from_numpy(rid), torch.from_numpy(col), torch.from_numpy(val),
        N_COLS)
    for form in ("xla", "pallas"):
        if form == "xla":
            last_j, sum_j = _contract_rect(jnp.asarray(rid), jnp.asarray(col),
                                           jnp.asarray(val), N_COLS)
        else:
            last_j, sum_j = stream_contract_runs(
                jnp.asarray(rid), jnp.asarray(col), jnp.asarray(val), N_COLS)
        np.testing.assert_array_equal(last_t.numpy(), np.asarray(last_j))
        np.testing.assert_array_equal(sum_t.numpy(), np.asarray(sum_j))


def test_contract_broadcast_rid_matches_full_plane(rng):
    """A per-row rid broadcast along W (the levels' and the finish's form)
    gives the same result as the materialized plane."""
    rid, col, val = _sorted_rect(rng, 4, 256, const_rid=True)
    rid_row = torch.from_numpy(rid[:, 0].copy())
    full = contract.stream_contract(torch.from_numpy(rid),
                                    torch.from_numpy(col),
                                    torch.from_numpy(val), N_COLS)
    bcast = contract.stream_contract(rid_row[:, None].expand(4, 256),
                                     torch.from_numpy(col),
                                     torch.from_numpy(val), N_COLS)
    for a, b in zip(full, bcast):
        assert torch.equal(a, b)


def _assert_same_sort(key, pays, key_o, pays_o):
    np.testing.assert_array_equal(key_o, np.sort(key, axis=1))
    for p, po in zip(pays, pays_o):
        for r in range(key.shape[0]):
            assert (sorted(zip(key[r].tolist(), p[r].tolist()))
                    == sorted(zip(key_o[r].tolist(), po[r].tolist())))


@pytest.mark.parametrize("n_pay", [1, 3])
def test_sort_plain_matches_jax_bitonic(rng, n_pay):
    R, W = 8, 1024
    key = rng.integers(0, 200, size=(R, W)).astype(np.int32)
    key[:, -50:] = np.iinfo(np.int32).max      # dead slots, as in the stream
    pays = [rng.integers(-1000, 1000, size=(R, W)).astype(np.int32)
            for _ in range(n_pay)]
    k_t, p_t = bitonic.row_sort(torch.from_numpy(key),
                                [torch.from_numpy(p) for p in pays])
    k_t = k_t.numpy()
    p_t = [p.numpy() for p in p_t]
    _assert_same_sort(key, pays, k_t, p_t)
    for fn in (jbitonic.bitonic_sort_pairs_pallas,
               jbitonic.bitonic_sort_pairs):
        k_j, p_j = fn(jnp.asarray(key), [jnp.asarray(p) for p in pays])
        np.testing.assert_array_equal(k_t, np.asarray(k_j))
        _assert_same_sort(key, pays, np.asarray(k_j),
                          [np.asarray(p) for p in p_j])


def test_sort_float_payload_round_trips(rng):
    key = rng.integers(0, 50, size=(3, 64)).astype(np.int32)
    val = rng.standard_normal((3, 64)).astype(np.float32)
    k_s, (v_s,) = bitonic.row_sort(torch.from_numpy(key),
                                   [torch.from_numpy(val)])
    assert v_s.dtype == torch.float32
    _assert_same_sort(key, [val.view(np.int32)], k_s.numpy(),
                      [v_s.numpy().view(np.int32)])


def test_cpu_wrappers_take_plain_path_and_do_not_count(rng):
    rid, col, val = _sorted_rect(rng, 4, 128)
    n1, n2, n4 = contract.LAUNCHES, bitonic.LAUNCHES, expand.LAUNCHES
    shapes = dict(bitonic.LAUNCH_SHAPES)
    k1_shapes = dict(contract.LAUNCH_SHAPES)
    k4_shapes = dict(expand.LAUNCH_SHAPES)
    k4_live = {k: list(v) for k, v in expand.LAUNCH_LIVE.items()}
    contract.stream_contract(torch.from_numpy(rid), torch.from_numpy(col),
                             torch.from_numpy(val), N_COLS)
    contract.stream_contract(torch.from_numpy(rid[:, :1]).expand(4, 128),
                             torch.from_numpy(col), torch.from_numpy(val),
                             N_COLS)
    bitonic.row_sort(torch.from_numpy(col), [torch.from_numpy(val)])
    for value in (("float32", "float32"), ("bfloat16", "float32")):
        args = expand_args(_expand_plan(value), 1)
        got = expand.stream_expand(*args, live=1000)
        assert planes_equal(got, expand.expand_plain(*args))
    assert (contract.LAUNCHES, bitonic.LAUNCHES) == (n1, n2)
    assert bitonic.LAUNCH_SHAPES == shapes
    assert contract.LAUNCH_SHAPES == k1_shapes
    assert expand.LAUNCHES == n4 and expand.LAUNCH_SHAPES == k4_shapes
    assert expand.LAUNCH_LIVE == k4_live


def test_expand_plain_unpacked_float32_equals_packed():
    """The plain expand of float32 operands apart (A's values through the
    A-source map, B's columns and values) equals that of the packed record,
    bit for bit, on every chunk of a plan: K4's unpacked float32 build and
    its packed one compute one function."""
    plan = _expand_plan()
    rec = plan.stream.rec
    unpacked = rec._replace(sa=rec.src, b=expand.Unpacked(
        plan.A.data, plan.B.indices, plan.B.data))
    for c in range(plan.stream.layout.n_chunks):
        got = expand.expand_plain(*expand_args(plan, c, unpacked))
        assert planes_equal(got, expand.expand_plain(*expand_args(plan, c)))


@pytest.mark.parametrize("R,W,words", [(3, 5000, 5), (1, 1 << 23, 2049),
                                       (512, 8192, 1025), (7, 4097, 9),
                                       (65536, 2048, None), (64, 256, None),
                                       (5, 1, None), (2, 4096, None)])
def test_contract_scratch(R, W, words):
    """K1's scratch: a tile counter and a status word a tile of 4096 slots
    (8 bytes each; the launcher clears them); none where W divides the
    tile (every tile starts at a row head, so no tile needs a carry: K3 on
    esc_fixed's power-of-two rows)."""
    sc = contract._scratch(torch.empty((R, W), dtype=torch.int32))
    if words is None:
        assert sc is None
    else:
        assert sc.dtype == torch.int64 and sc.shape == (words,)


@pytest.mark.parametrize("n_pay", [0, 2])
def test_sort_plain_is_stable(rng, n_pay):
    """Equal keys keep their slot order, as the card's K2 does: the plain
    version, which the card's tests hold K2 to exactly, is numpy's stable
    argsort applied to every payload."""
    key = rng.integers(-3, 3, size=(5, 512)).astype(np.int32)
    key[:, ::7] = np.iinfo(np.int32).max
    pays = [rng.integers(-1000, 1000, size=(5, 512)).astype(np.int32)
            for _ in range(n_pay)]
    k_t, p_t = bitonic.row_sort(torch.from_numpy(key),
                                [torch.from_numpy(p) for p in pays])
    order = np.argsort(key, axis=1, kind="stable")
    np.testing.assert_array_equal(k_t.numpy(),
                                  np.take_along_axis(key, order, 1))
    for p, po in zip(pays, p_t):
        np.testing.assert_array_equal(po.numpy(),
                                      np.take_along_axis(p, order, 1))


@pytest.mark.parametrize("R,W,n_pay,tile,passes,scratch", [
    (65536, 4096, 2, 4096, 0, ()),             # esc_fixed's owner sorts
    (65536, 2048, 1, 2048, 0, ()),             # its column sort
    (65536, 2048, 2, 2048, 0, ()),             # its compaction
    (512, 8192, 1, 8192, 0, ()),               # the stream chunk sort
    (512, 8192, 3, 8192, 0, ()),               # its compaction with rid
    (7, 1, 1, 1, 0, ()),
    (3, 2, 2, 2, 0, ()),
    (1, 1 << 14, 0, 8192, 1, (1, 2, 1, 1 << 14)),
    (1, 1 << 15, 3, 8192, 2, (2, 2, 1, 1 << 15)),
    (2, 1 << 17, 1, 8192, 4, (2, 2, 2, 1 << 17)),
    (2, 1 << 20, 1, 8192, 7, (2, 2, 2, 1 << 20)),   # the wide finish
    (3, 1 << 20, 2, 8192, 7, (2, 2, 3, 1 << 20)),
    (1, 1 << 24, 1, 8192, 11, (2, 2, 1, 1 << 24))])  # the giant row
def test_sort_plan(R, W, n_pay, tile, passes, scratch):
    """K2's host plan: rows of one tile sort in one CTA with no scratch;
    wider rows take log2(W / 8192) merge passes over one (key, slot) plane
    pair for a single pass, two pairs for more. Planning launches
    nothing."""
    n0, shapes = bitonic.LAUNCHES, dict(bitonic.LAUNCH_SHAPES)
    plan = bitonic.sort_plan(R, W, n_pay)
    assert plan == (tile, passes, scratch)
    assert plan.tile * 2 ** plan.merge_passes == W
    assert bitonic.LAUNCHES == n0 and bitonic.LAUNCH_SHAPES == shapes


@pytest.mark.parametrize("case", ["sort_width", "sort_plan_payloads",
                                  "sort_payloads",
                                  "sort_dtype", "contract_dtype",
                                  "contract_shape", "expand_dtype",
                                  "expand_contiguous", "expand_record",
                                  "expand_values", "expand_sid_base",
                                  "expand_device"])
def test_wrappers_reject_what_kernels_do_not_take(case):
    k = torch.zeros((2, 64), dtype=torch.int32)
    v = torch.zeros((2, 64), dtype=torch.float32)
    if case.startswith("expand"):
        ex = list(expand_args(_expand_plan(), 0))
        if case == "expand_dtype":
            ex[0] = ex[0].long()
        elif case == "expand_contiguous":
            ex[2] = torch.stack([ex[2], ex[2]], 1)[:, 0]
        elif case == "expand_record":
            ex[5] = torch.cat([ex[5], ex[5][:, :1]], 1)
        elif case == "expand_values":
            ex[5] = expand.Unpacked(ex[3].view(torch.float32),
                                    ex[5][:, 0].contiguous(),
                                    ex[5][:, 1].contiguous())
        elif case == "expand_sid_base":
            ex[7] = ex[7].reshape(1)
        else:
            ex[4] = ex[4].to("meta")
        with pytest.raises(ValueError):
            expand.stream_expand(*ex)
        return
    with pytest.raises(ValueError):
        if case == "sort_width":
            # any width of 1 and more (a power of two or padded to one)
            bitonic.row_sort(torch.zeros((2, 0), dtype=torch.int32), [])
        elif case == "sort_plan_payloads":
            bitonic.sort_plan(2, 64, 4)
        elif case == "sort_payloads":
            bitonic.row_sort(k, [k, k, k, k])
        elif case == "sort_dtype":
            bitonic.row_sort(k.long(), [])
        elif case == "contract_dtype":
            # floating values of 16, 32 or 64 bits only
            contract.stream_contract(k, k, v.int(), N_COLS)
        else:
            contract.stream_contract(k[:, :32], k, v, N_COLS)


def test_sort_profile_needs_a_card(monkeypatch):
    """K2's profile times the card only: without one it raises, naming the
    CPU argument, and times no plain version in its place."""
    from speck_tpu_torch.probes import sort_profile
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sort_profile.main()


def test_expand_profile_needs_a_card(monkeypatch):
    """K4's profile times the card only: without one it raises, and times
    no plain version in its place."""
    from speck_tpu_torch.probes import expand_profile
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        expand_profile.main()
