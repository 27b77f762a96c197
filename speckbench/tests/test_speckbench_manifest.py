"""BENCHMARK.json against the format's rules, and every name in it found
as a file."""

import re

from speckbench.manifest import HERE, REPO, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_lines():
    b = Bench.load()
    m = b.m
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert all(PATH.match(p) and not p.endswith("_torch") for p in m["paths"])
    assert all(LINE.match(w) for w in m["command"])
    assert len(m["command"]) <= 32 and 1 <= len(m["paths"]) <= 16
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("speckbench/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == E2E_KEYS
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == LAYER_KEYS
        assert LINE.match(e["layer"])
    names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for e in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    for f in HERE.rglob("*"):
        if "__pycache__" not in f.parts:
            assert PATH.match(str(f.relative_to(REPO))), f


def test_every_name_is_found():
    b = Bench.load()
    cells = {w["name"] for w in b.m["workloads"]}
    configs = {c["name"] for c in b.m["configs"]}
    assert configs == {w["config"] for w in b.m["workloads"]}
    for w in b.m["workloads"]:
        cfg = b.config(w["config"])
        b.generator(cfg["generator"])
        traffic = b.traffic(w["traffic"])
        assert traffic["entry"]
        for op in traffic.get("operands", {}).values():
            assert callable(b.generator(op["generator"]).operand)
        assert cfg["limits"]["struct_rows"] == 0
        e2e = {e["name"] for e in b.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert b.per_layer(w["name"]), w["name"]
    e2e = {e["name"] for e in b.m["end_to_end"]}
    for e in b.m["end_to_end"]:
        assert set(e.get("workloads", cells)) <= cells
    for e in b.m["per_layer"]:
        assert e["moves"] in e2e and set(e["workloads"]) <= cells
        assert callable(b.reader(e["name"]).read)
