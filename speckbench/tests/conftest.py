"""Tiny cells for the CPU tests: configurations and a traffic mix written
under a temporary directory and found by name, beside a manifest that
copies BENCHMARK.json's metrics."""

import json

import pytest
import torch

from speckbench.manifest import HERE, REPO, Bench

TINY = {
    "hs": {"generator": "stencil27", "nx": 6, "ny": 5, "nz": 4,
           "values": "normal", "value_dtype": "float64",
           "limits": {"struct_rows": 0, "val_err": 1e-10}},
    "gs": {"generator": "kronecker", "SCALE": 8, "graph_seed": 3,
           "edgefactor": 16,
           "initiator": [0.57, 0.19, 0.19, 0.05], "values": "uniform",
           "value_dtype": "float32",
           "limits": {"struct_rows": 0, "val_err": 1e-4}},
}
CELLS = [("gs.AxA", "gs", "square"), ("hs.AxA", "hs", "square"),
         ("hs.reuse", "hs", "reuse"), ("gs.reuse", "gs", "reuse"),
         ("gs.pair", "gs", "pair"), ("hs.galerkin", "hs", "galerkin")]


def manifest():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture()
def tiny(tmp_path):
    """A Bench over the tiny cells: the configurations and the traffic mix
    ``pair`` (two value sets) live only under ``tmp_path``."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    for name, cfg in TINY.items():
        (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "pair.json").write_text(json.dumps(
        {"entry": "plan_execute", "value_sets": 2}))
    m = manifest()
    m["configs"] = [{"name": n, "file": str(tmp_path / "configs" / f"{n}.json"),
                     "reduced": []} for n in TINY]
    m["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1}
                      for n, c, t in CELLS]
    for e in m["end_to_end"] + m["per_layer"]:
        e.pop("workloads", None)
    return Bench(m, roots=(tmp_path, HERE))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
