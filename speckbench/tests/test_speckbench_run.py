"""Whole runs of tiny cells on the CPU (the program's plain kernel
versions), the faults and the control that must read not correct, and the
modules a run loads."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

import speck_tpu_torch
from speck_tpu_torch.ops.spgemm import SpgemmPlan
from speckbench import run as R
from speckbench.manifest import REPO

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def one(bench, cell, trace=False, dtype=None, seed=SEED):
    return R.run(bench, cell, seed, 0.3, trace, CPU, dtype)


@pytest.mark.parametrize("cell", ["gs.AxA", "hs.AxA", "hs.reuse", "gs.reuse"])
def test_tiny_cells_are_correct(tiny, cell):
    res = one(tiny, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "call_ms", "call_p90_ms"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["struct_rows"] == {"value": 0, "limit": 0}
    assert res["checks"]["val_err"]["value"] <= res["checks"]["val_err"]["limit"]
    json.loads(json.dumps(res))


def test_added_config_and_traffic_are_found_by_name(tiny):
    # gs.pair's configuration and traffic exist only under the test's own
    # directory, beside the benchmark's files
    res = one(tiny, "gs.pair")
    assert res["correct"] and res["attempted"] >= 1


@pytest.mark.parametrize("cell", ["hs.AxA", "gs.reuse"])
def test_traced_run_reports_the_layers(tiny, cell):
    res = one(tiny, cell, trace=True)
    assert res["correct"]
    want = {"numeric_ms"} | (
        {"plan_ms", "count_ms"} if cell.endswith("AxA") else set())
    # no device metric from a CPU run
    assert set(res["metrics"]) == want
    assert "busy_s" not in res["device"] and "breakdown" not in res


def half_rows(C):
    h = C.shape[0] // 2
    ip = C.indptr.clone()
    ip[h + 1:] = ip[h]
    return dataclasses.replace(C, indptr=ip, nnz=int(ip[h]))


def altered(C):
    data = C.data.clone()
    data[C.nnz // 2] += 1.0
    return dataclasses.replace(C, data=data)


@pytest.mark.parametrize("fault", [half_rows, altered])
@pytest.mark.parametrize("cell", ["gs.AxA", "hs.AxA", "hs.galerkin"])
def test_a_broken_product_is_not_correct(tiny, monkeypatch, fault, cell):
    orig = speck_tpu_torch.spgemm
    monkeypatch.setattr(speck_tpu_torch, "spgemm",
                        lambda A, B, cfg=None, timings=None:
                        fault(orig(A, B, cfg, timings)))
    assert not one(tiny, cell)["correct"]


@pytest.mark.parametrize("fault", [half_rows, altered])
@pytest.mark.parametrize("cell", ["hs.reuse", "gs.reuse"])
def test_a_broken_execute_is_not_correct(tiny, monkeypatch, fault, cell):
    orig = SpgemmPlan.execute
    monkeypatch.setattr(SpgemmPlan, "execute",
                        lambda self, A=None, B=None, timings=None:
                        fault(orig(self, A, B, timings)))
    assert not one(tiny, cell)["correct"]


@pytest.mark.parametrize("cell", ["hs.reuse", "gs.reuse"])
def test_a_plan_that_keeps_its_values_is_not_correct(tiny, monkeypatch, cell):
    orig = SpgemmPlan.execute
    monkeypatch.setattr(SpgemmPlan, "execute",
                        lambda self, A=None, B=None, timings=None:
                        orig(self, timings=timings))
    assert not one(tiny, cell)["correct"]


def test_a_failing_warm_call_raises(tiny, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(speck_tpu_torch, "spgemm", boom)
    with pytest.raises(RuntimeError):
        one(tiny, "gs.AxA")  # the warm call fails in set-up


@pytest.mark.parametrize("cell,low", [("hs.AxA", torch.float32),
                                      ("hs.reuse", torch.float32),
                                      ("gs.AxA", torch.bfloat16),
                                      ("gs.reuse", torch.bfloat16)])
def test_the_control_is_not_correct(tiny, cell, low):
    # the program's own path one precision below the configuration's
    res = one(tiny, cell, dtype=low)
    assert res["checks"]["struct_rows"]["value"] == 0
    assert not res["correct"]


def test_main_without_a_card_prints_no_result(capsys, no_cuda):
    assert R.main(["--workload", "graph500.AxA", "--seed", "1",
                   "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    import shutil

    shutil.copytree(REPO / "speckbench", tmp_path / "speckbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "speckbench", "--workload",
                        "hpcg27.reuse", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
from speckbench.manifest import Bench
m = json.loads({manifest!r})
b = Bench(m, roots=[{tmp!r}] + Bench(m).roots)
{body}
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def loaded(tiny, body):
    src = PROBE.format(repo=str(REPO), manifest=json.dumps(tiny.m),
                       tmp=str(tiny.roots[0]), body=body)
    p = subprocess.run([sys.executable, "-c", src], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax(tiny):
    mods = loaded(tiny, """
import torch
from speckbench import run as R
for cell in ("gs.AxA", "hs.reuse"):
    for trace in (False, True):
        assert R.run(b, cell, 5, 0.2, trace, torch.device("cpu"))["correct"]
for m in b.m["per_layer"]:
    b.reader(m["name"])
""")
    assert "speck_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "speck_tpu"}


def test_the_reference_loads_nothing_of_the_program(tiny):
    mods = loaded(tiny, """
from speckbench import inputs, kernel_bytes, operands, reference, trace
for g in ("kronecker", "stencil27", "prolong_trilinear"):
    b.generator(g)
""")
    assert not mods & {"speck_tpu_torch", "jax", "jaxlib", "flax",
                       "speck_tpu"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell,low", [("gs.AxA", torch.bfloat16),
                                      ("hs.reuse", torch.float32)])
def test_tiny_cells_on_the_card(tiny, cuda_device, cell, low):
    res = R.run(tiny, cell, SEED, 0.5, True, cuda_device)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert {"numeric_ms", "device.idle"} <= set(res["metrics"])
    assert res["breakdown"]["device_ops"]
    assert not R.run(tiny, cell, SEED, 0.3, False, cuda_device, low)["correct"]


def test_a_call_that_fails_in_the_window_is_not_correct(tiny, monkeypatch):
    orig, calls = SpgemmPlan.execute, []

    def fail_after_warm(self, A=None, B=None, timings=None):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return orig(self, A, B, timings)

    monkeypatch.setattr(SpgemmPlan, "execute", fail_after_warm)
    res = one(tiny, "hs.reuse")
    assert not res["correct"] and res["failed"] == 1
    assert set(res["metrics"]) == {"setup_s"}
