"""``graph500_bf16`` at a small SCALE on the CPU: the configuration's
Kronecker graph with bfloat16 weight sets drawn as the benchmark draws
them, multiplied by ``spgemm`` and by one kept plan's ``execute(A_k,
A_k)``, held to ``speckbench.reference`` (float64) under the
configuration's own ``val_err`` limit; and the two controls that the limit
has to fail: the reference on inputs rounded through float8, and the
reference with every entry's sum kept in bfloat16."""

import dataclasses
import importlib

import pytest
import torch

import speck_tpu_torch as pt
from speckbench import reference
from speckbench.inputs import draw_values
from speckbench.manifest import REPO, Bench, load_module
from speckbench.window import _device_csr

tsp = importlib.import_module("speck_tpu_torch.ops.spgemm")
limits = load_module(REPO / "scripts" / "graph500_bf16_limits.py",
                     "graph500_bf16_limits")

BENCH = Bench.load()
CFG = BENCH.config("graph500_bf16")
LIMIT = CFG["limits"]["val_err"]
SMALL = dict(CFG, SCALE=10)
SEED = 2 ** 33 + 5
CPU = torch.device("cpu")
# the card's plan at a small size: two-phase, wide rows over merge levels
# and direct-copy classes, the packed key (the default fuses at SCALE 10)
CONFIGS = {"default": {},
           "two_phase": dict(enable_dense=False, enable_dia=False,
                             enable_sdia=False, dia_rows=False,
                             stream_width=512, product_budget=1 << 16,
                             fused_staging_budget=1 << 10)}


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of small torch ops: on one thread, since more threads only
    spin-wait at each op when the other test workers keep the cores
    busy."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return BENCH.generator(SMALL["generator"]).structure(SMALL, SEED)


def values(st, k):
    return draw_values(st, SMALL, SEED, k, CPU)


def held(st, v, C):
    a = reference.Operand.of(st, v)
    return reference.compare(C.indptr, C.indices, C.data, C.shape, a, a)


def test_config_is_graph500_in_bfloat16():
    base = BENCH.config("graph500")
    own = {"value_dtype", "limits", "limits_why", "deployment", "assumed"}
    assert {k: v for k, v in CFG.items() if k not in own} == {
        k: v for k, v in base.items() if k not in own}
    assert CFG["value_dtype"] == "bfloat16"
    assert set(CFG["limits"]) == set(CFG["limits_why"]) == {"struct_rows",
                                                            "val_err"}
    entry, = [c for c in BENCH.m["configs"] if c["name"] == "graph500_bf16"]
    assert entry["reduced"] == ["SCALE"]
    cell = BENCH.workload("graph500.bf16")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "graph500_bf16", "reuse", 1)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("entry", ["spgemm", "plan_execute"])
def test_products_within_the_limit(graph, entry, config):
    cfg = pt.SpgemmConfig(**CONFIGS[config])
    A0 = _device_csr(graph, values(graph, 0), torch.bfloat16, CPU)
    routes = dict(tsp.ROUTES)
    if entry == "spgemm":
        outs = [(values(graph, 0), pt.spgemm(A0, A0, cfg))]
    else:
        plan = pt.plan_spgemm(A0, A0, cfg)
        outs = []
        for k in (1, 2):
            v = values(graph, k)
            Ak = dataclasses.replace(A0, data=v)
            outs.append((v, plan.execute(Ak, Ak)))
    assert tsp.ROUTES["stream"] == routes.get("stream", 0) + 1
    for v, C in outs:
        assert C.data.dtype == torch.bfloat16
        found = held(graph, v, C)
        assert found["struct_rows"] == 0
        # C in bfloat16 is rounded at least once (2^-8 relative): a
        # limit far below that could not be met
        assert 2.0 ** -9 < found["val_err"] <= LIMIT


@pytest.mark.parametrize("control", sorted(limits.CONTROLS))
def test_controls_fail_the_limit(graph, control):
    """Inputs in float8 and sums in bfloat16 keep the structure but fail
    ``val_err``: the limit would catch either precision."""
    v = values(graph, 1)
    found = limits.held(graph, v, limits.CONTROLS[control](graph, v))
    assert found["struct_rows"] == 0
    assert found["val_err"] > LIMIT


def test_bf16_sums_round_every_partial_sum():
    seg = torch.tensor([0, 0, 0, 1, 2, 2])
    prod = torch.tensor([256.0, 1.0, 1.0, 3.0, 0.5, 0.25],
                        dtype=torch.float64)
    got = limits._sequential_bf16(seg, prod, 3)
    # 256 + 1 rounds back to 256 in bfloat16 (8 bits), twice
    assert got.dtype == torch.bfloat16
    assert got.tolist() == [256.0, 3.0, 0.75]
