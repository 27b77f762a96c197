"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a configuration's file
names its generator. Each is looked up by its name alone, so that adding
one is adding files and entries:

- a configuration: the ``file`` of its ``configs`` entry (JSON);
- its generator: ``generators/<generator>.py``, a ``structure(cfg, seed)``;
- a traffic mix: ``traffic/<traffic>.json``;
- a per-layer metric: ``metrics/<name>.py``, a ``read(rec)``.

``roots`` lists the directories searched in order (``speckbench/`` alone
unless a caller adds its own in front).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import List, Sequence

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    def __init__(self, manifest: dict, roots: Sequence[Path] = (HERE,)):
        self.m = manifest
        self.roots: List[Path] = [Path(r) for r in roots]

    @staticmethod
    def load(path: Path = REPO / "BENCHMARK.json",
             roots: Sequence[Path] = (HERE,)) -> "Bench":
        return Bench(json.loads(Path(path).read_text()), roots)

    def _find(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(r) for r in self.roots]}")

    def _entry(self, key: str, name: str) -> dict:
        for e in self.m[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((REPO / self._entry("configs", name)["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self._find("traffic", name, ".json").read_text())

    def generator(self, name: str):
        return load_module(self._find("generators", name, ".py"),
                           f"speckbench_generator_{name}")

    def reader(self, metric: str):
        return load_module(self._find("metrics", metric, ".py"),
                           f"speckbench_metric_{metric.replace('.', '_')}")

    def _applies(self, metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", [cell])

    def end_to_end(self, cell: str) -> List[dict]:
        return [e for e in self.m["end_to_end"] if self._applies(e, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        reported = {e["name"] for e in self.end_to_end(cell)}
        return [e for e in self.m["per_layer"]
                if self._applies(e, cell) and e["moves"] in reported]
