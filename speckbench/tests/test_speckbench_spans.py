"""The program's ranges in a trace (``spans.py``) on synthetic events: the
nesting, the device operations tied to their launch, the idle put down to
the range open on the host; the metrics they give; the accepted readers
unmoved by the new keys of a record; and the readbacks of one call of a
tiny cell (``syncs``)."""

from types import SimpleNamespace

import pytest
import torch

from speckbench import spans as sp
from speckbench import syncs as sy
from speckbench.manifest import Bench

RANGES = [("speck.loadBalanceCounting", 0, 100),
          ("speck.plan.host_layout", 10, 40),
          ("speck.readback.plan_pack", 20, 30),
          ("speck.plan.groups", 40, 60),
          ("speck.route.stream", 50, 50),
          ("speck.spGEMMNumeric", 100, 150),
          ("speck.numeric.chunk", 110, 140)]


def test_timeline_nests_and_orders_ranges():
    pieces = sp.timeline(RANGES, -10, 170)
    assert [(a, b) for a, b, _ in pieces] == [
        (-10, 0), (0, 10), (10, 20), (20, 30), (30, 40), (40, 60),
        (60, 100), (100, 110), (110, 140), (140, 150), (150, 170)]
    paths = [p for _, _, p in pieces]
    assert paths[0] == () and paths[-1] == ()
    assert paths[3] == ("speck.loadBalanceCounting",
                        "speck.plan.host_layout", "speck.readback.plan_pack")
    # a range that starts where another ends opens after it closes; the
    # zero-length route mark holds nothing
    assert paths[5] == ("speck.loadBalanceCounting", "speck.plan.groups")
    assert paths[7] == ("speck.spGEMMNumeric",)


def test_attribute_device_and_idle():
    # device busy 25..35 (launched in the readback) and 112..138 (launched
    # in the numeric chunk); one op whose launch is not in the window
    dev = [("k", 25, 35, 1), ("k", 112, 138, 2), ("k", 160, 161, 99)]
    launch = {1: 22, 2: 111}
    out = sp.attribute(RANGES, launch, dev, (-10, 170))
    assert out["device_s"] == pytest.approx(
        {"speck.readback.plan_pack": 10e-6, "speck.numeric.chunk": 26e-6,
         "unlinked": 1e-6})
    idle = out["idle_s"]
    assert idle["outside"] == pytest.approx((10 + 10 + 9) * 1e-6)
    assert idle["speck.loadBalanceCounting"] == pytest.approx(50e-6)
    assert idle["speck.plan.host_layout"] == pytest.approx(15e-6)
    assert idle["speck.readback.plan_pack"] == pytest.approx(5e-6)
    assert idle["speck.plan.groups"] == pytest.approx(20e-6)
    assert idle["speck.numeric.chunk"] == pytest.approx(4e-6)
    assert idle["speck.spGEMMNumeric"] == pytest.approx(20e-6)
    st = out["idle_stage_s"]
    assert st["speck.loadBalanceCounting"] == pytest.approx(90e-6)
    assert st["speck.spGEMMNumeric"] == pytest.approx(24e-6)
    # every idle instant is put down once: the sums equal the gaps
    total = (180 - 10 - 26 - 1) * 1e-6
    assert sum(idle.values()) == pytest.approx(total)
    assert sum(st.values()) == pytest.approx(total)


def ev(name, start, end, kind="CPU", thread=1, id=0, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=SimpleNamespace(name=kind), thread=thread, id=id,
        is_user_annotation=annotation)


def test_read_events_takes_the_window_thread_and_skips_marks():
    events = [ev("speckbench.window", 0, 100),
              ev("speckbench.window", 0, 100, kind="CUDA", annotation=True),
              ev("speck.spGEMMNumeric", 10, 90),
              ev("speck.spGEMMNumeric", 12, 88, kind="CUDA",
                 annotation=True),
              ev("speck.other_thread", 10, 20, thread=2),
              ev("speck.before", -20, -10),
              ev("aten::index", 30, 31, id=71),
              ev("cudaLaunchKernel", 30.5, 30.9, id=71),
              ev("cudaLaunchKernel", 31.5, 31.9, id=72, thread=2),
              ev("index_kernel", 40, 50, kind="CUDA", id=71)]
    ranges, launch, dev, window = sp.read_events(events, "speckbench.window")
    assert ranges == [("speck.spGEMMNumeric", 10, 90)]
    assert dev == [("index_kernel", 40, 50, 71)]
    assert launch == {71: 30.5} and window == (0, 100)
    rec = sp.record(events, "speckbench.window")
    assert rec["device_s"] == {"speck.spGEMMNumeric": pytest.approx(10e-6)}
    assert rec["stages_seen"] == ["speck.spGEMMNumeric"]


def full_rec(**kw):
    r = {"stages": [{"countProducts": 1.0, "loadBalanceCounting": 2.0,
                     "spGEMMCounting": 4.0, "allocC": 0.5,
                     "spGEMMNumeric": 3.0}],
         "launches": {"k1": {(512, 8192, "plane", "float32"): 2}, "k3": {},
                      "k2": {(4, 1024, 1): 3}},
         "device_ops": [("void contract_kernel<float, true>", 0, 10.0),
                        ("void radix_tile_kernel<8, false>", 0, 10.0)],
         "busy_s": 0.25, "window_s": 1.0, "profiled_calls": 5}
    r.update(kw)
    return r


NEW_KEYS = dict(
    spans={"device_s": {}, "idle_s": {},
           "idle_stage_s": {"speck.loadBalanceCounting": 0.01,
                            "speck.countProducts": 0.005,
                            "speck.spGEMMCounting": 0.002,
                            "speck.allocC": 0.001,
                            "speck.spGEMMNumeric": 0.003, "outside": 0.1},
           "stages_seen": ["speck.countProducts", "speck.spGEMMCounting",
                           "speck.spGEMMNumeric"]},
    readbacks={"plan_pack": [5, 100], "nnz_meta": [5, 40],
               "wide_totals": [10, 80]},
    live={"k1": {(512, 8192, "plane", "float32"): [2, 512 * 8192]},
          "k2": {(4, 1024, 1): [2, 2048], (2, 16, 2): [1, 32]}})


def test_metrics_of_a_record():
    r = full_rec(**NEW_KEYS)
    m = {n: f(r) for n, f in sp.METRICS.items()}
    assert m["plan.idle_ms"] == pytest.approx(3.0)
    assert m["count.idle_ms"] == pytest.approx(0.6)
    assert m["numeric.idle_ms"] == pytest.approx(0.6)
    assert m["host.readbacks"] == 4.0
    assert m["k2.live_share"] == pytest.approx(
        100 * (2048 + 32) / (2 * 4 * 1024 + 2 * 16))
    assert m["k1.live_share"] == pytest.approx(50.0)
    # a record without the program's ranges and counters (the parent's):
    # nothing to read
    assert all(f(full_rec()) is None for f in sp.METRICS.values())
    # a reuse call plans nothing
    no_plan = dict(NEW_KEYS["spans"], stages_seen=["speck.spGEMMNumeric"])
    assert sp.plan_idle_ms(full_rec(spans=no_plan)) is None
    assert sp.k2_live_share(full_rec(live={"k1": {}, "k2": {}})
                            ) is None


@pytest.mark.parametrize("name", ["plan_ms", "count_ms", "numeric_ms",
                                  "k1_roofline", "k2_roofline",
                                  "device.idle", "device.busy_ms"])
def test_accepted_readers_ignore_the_new_keys(name):
    reader = Bench.load().reader(name)
    assert reader.read(full_rec()) == reader.read(full_rec(**NEW_KEYS))
    assert reader.read(full_rec()) is not None


@pytest.mark.parametrize("cell", ["gs.AxA", "hs.reuse"])
def test_readbacks_of_one_call_of_a_tiny_cell(tiny, cell):
    out = sy.check(tiny, cell, 2 ** 31 + 11, torch.device("cpu"))
    assert out["syncs"] is None and out["card"] == "cpu"
    kinds = out["readback_kinds"]
    assert out["readbacks"] == sum(n for n, _ in kinds.values())
    if cell.endswith("AxA"):
        # the planning pack and C's meta at least
        assert {"plan_pack", "nnz_meta"} <= set(kinds)
        assert all(b > 0 for _, b in kinds.values())
    else:
        # a reuse call plans nothing and reads nothing back
        assert out["readbacks"] == 0 and kinds == {}
