"""The metric arithmetic: the window's statistics, nested spans, interval
unions, the breakdown, the frozen byte formulas and the readers."""

import statistics

import pytest

from speckbench import kernel_bytes as kb
from speckbench import trace as tr
from speckbench.manifest import Bench


def test_p90_and_spread():
    times = list(range(1, 101))
    assert tr.p90(times) == statistics.quantiles(times, n=10)[-1]
    assert 90 < tr.p90(times) < 92
    assert tr.p90([3.0]) == 3.0
    assert tr.spread([10, 10, 10, 10]) == 0.0
    q1, q2, q3 = statistics.quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert tr.spread([6, 1, 5, 2, 4, 3]) == pytest.approx((q3 - q1) / 3.5)


def test_union_covered_and_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)]
    assert tr.union(iv) == [(0, 3), (5, 9), (12, 13)]
    assert tr.covered(iv) == 8
    assert tr.gaps(iv, 0, 14) == [(3, 5), (9, 12), (13, 14)]
    assert tr.gaps(iv, -1, 4) == [(-1, 0), (3, 4)]
    assert tr.gaps([], 0, 1) == [(0, 1)]


def test_self_times_of_nested_stages():
    # a diagonal-plane route: loadBalanceCounting holds the count and alloc
    spans = [("spGEMMCounting", 12.0, 20.0), ("allocC", 20.0, 21.0),
             ("loadBalanceCounting", 10.0, 30.0), ("spGEMMNumeric", 30.0, 35.0)]
    st = tr.self_times(spans)
    assert st == {"spGEMMCounting": 8.0, "allocC": 1.0,
                  "loadBalanceCounting": 11.0, "spGEMMNumeric": 5.0}
    # a stream route: disjoint stages, twice (row blocks) add up
    flat = [("countProducts", 0, 2), ("loadBalanceCounting", 2, 5),
            ("countProducts", 5, 6), ("loadBalanceCounting", 6, 10)]
    assert tr.self_times(flat) == {"countProducts": 3, "loadBalanceCounting": 7}
    rec = {"stages": [st, {"spGEMMNumeric": 7.0}]}
    assert tr.stage_mean(rec, ("spGEMMNumeric",)) == 6.0
    assert tr.stage_mean(rec, ("countProducts",)) is None


def test_breakdown_names_gaps_by_host_ops():
    dev = [("void radix_tile_kernel<16>(int*)", 10, 20),
           ("void contract_kernel<float>(int*)", 30, 35),
           ("void radix_tile_kernel<16>(int*)", 36, 40)]
    host = [("aten::sort", 5, 12), ("aten::item", 18, 22),
            ("aten::index_select", 28, 31)]
    bd = tr.breakdown(dev, (0, 50), host)
    assert [n for n, _ in bd["device_ops"]] == ["radix_tile_kernel<16>",
                                                "contract_kernel<float>"]
    assert [s for _, s in bd["device_ops"]] == pytest.approx([14e-6, 5e-6])
    # the longest gaps, ties in time order
    assert [n for n, _ in bd["idle_gaps"]][:3] == [
        "window start .. aten::sort", "aten::item .. aten::index_select",
        "aten::index_select"]
    assert [s for _, s in bd["idle_gaps"]] == pytest.approx(
        [10e-6, 10e-6, 10e-6, 1e-6])


def test_frozen_byte_formulas():
    assert kb.k1_bytes(512, 8192, "plane") == 17 * 512 * 8192
    assert kb.k1_bytes(1, 8, "row") == 13 * 8
    assert kb.k1_bytes(2, 8, "plane", "float64") == 25 * 16
    assert kb.k1_bytes(2, 8, "row", "bfloat16") == 9 * 16
    assert kb.k3_bytes(4, 8) == 13 * 32 and kb.k3_bytes(1, 1, "float64") == 21
    assert kb.k2_bytes(512, 8192, 1) == 16 * 512 * 8192
    assert kb.k2_bytes(3, 5, 3) == 32 * 15
    assert kb.HBM_BYTES_PER_S == 3.35e12


def rec(**kw):
    base = {"stages": [], "device_ops": [], "busy_s": 0.0, "window_s": 1.0,
            "launches": {"k1": {}, "k3": {}, "k2": {}}}
    base.update(kw)
    return base


def test_readers():
    b = Bench.load()
    k1 = {(512, 8192, "plane", "float32"): 2}
    us = 2 * kb.k1_bytes(512, 8192, "plane") / kb.HBM_BYTES_PER_S * 1e6
    r = rec(launches={"k1": k1, "k3": {}, "k2": {(4, 1024, 1): 3}},
            device_ops=[("void contract_kernel<float, true>", 0, us),
                        ("contract_scratch_clear", us, 1.25 * us),
                        ("void radix_tile_kernel<8, false>", 0, 10.0)],
            busy_s=0.25, window_s=1.0, profiled_calls=5,
            stages=[{"countProducts": 1.0, "loadBalanceCounting": 2.0,
                     "spGEMMCounting": 4.0, "allocC": 0.5,
                     "spGEMMNumeric": 3.0}])
    assert b.reader("k1_roofline").read(r) == pytest.approx(80.0)
    assert b.reader("k2_roofline").read(r) == pytest.approx(
        100 * 3 * kb.k2_bytes(4, 1024, 1) / kb.HBM_BYTES_PER_S / 10e-6)
    assert b.reader("device.idle").read(r) == pytest.approx(75.0)
    assert b.reader("device.busy_ms").read(r) == pytest.approx(50.0)
    assert b.reader("plan_ms").read(r) == 3.0
    assert b.reader("count_ms").read(r) == 4.5
    assert b.reader("numeric_ms").read(r) == 3.0
    # nothing to read: no launch, no device operation, no span
    empty = rec()
    for name in ("k1_roofline", "k2_roofline", "device.idle",
                 "device.busy_ms", "plan_ms",
                 "count_ms", "numeric_ms"):
        assert b.reader(name).read(empty) is None
