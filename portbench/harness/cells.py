"""Finds everything a cell needs by the names in `BENCHMARK.json`: its
configuration file, its traffic mix (`traffic/<name>.json`), the driver
the mix names (`drivers/<driver>.py`), the model family the
configuration names (`families/<family>.py`, with its plain reference),
the output check's limits (`limits/<workload>.json`) and each per-layer
metric's reader (`metrics/<metric>.py`). A new cell is new files and new
entries; no file here changes for it."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """`BENCHMARK.json` of the checkout at `root` and the files it names,
    read from `root`'s `portbench/`."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = _json(os.path.join(root, "BENCHMARK.json"))
        self.dir = os.path.join(root, "portbench")

    def workloads(self) -> list[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def cell(self, workload: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(workloads: {', '.join(self.workloads())})")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return _json(os.path.join(self.dir, "limits", f"{workload}.json"))

    def metrics(self, workload: str, kind: str) -> list[dict]:
        """The `end_to_end` or `per_layer` metrics this cell reports: those
        that list it, and those that list no cells."""
        return [m for m in self.spec[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> ModuleType:
        """`metrics/<metric>.py`, loaded from its file (a metric's name may
        hold dots)."""
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def driver(trf: dict) -> ModuleType:
    return importlib.import_module(f"portbench.drivers.{trf['driver']}")


def family(cfg: dict) -> ModuleType:
    return importlib.import_module(f"portbench.families.{cfg['family']}")
