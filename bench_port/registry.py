"""Finds the pieces of a cell by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class Registry:
    """The benchmark's files under ``root`` (this package's directory by
    default), and ``BENCHMARK.json`` at ``benchmark`` (the checkout's)."""

    def __init__(self, root: str = HERE, benchmark: Optional[str] = None):
        self.root = root
        self.benchmark_path = benchmark or os.path.join(os.path.dirname(root), "BENCHMARK.json")
        with open(self.benchmark_path) as f:
            self.bench = json.load(f)

    def _json(self, *parts: str) -> dict:
        with open(os.path.join(self.root, *parts)) as f:
            return json.load(f)

    def _module(self, folder: str, name: str) -> ModuleType:
        path = os.path.join(self.root, folder, name + ".py")
        spec = importlib.util.spec_from_file_location(f"bench_port.{folder}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def workload(self, name: str) -> dict:
        """The ``workloads`` entry of ``name``."""
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.benchmark_path}")

    def config(self, name: str) -> dict:
        """The configuration's file, as its ``configs`` entry names it."""
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(os.path.dirname(self.benchmark_path), c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r}")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name + ".json")

    def limits(self, workload: str) -> dict:
        """The limits of the numbers compared in this cell."""
        return self._json("checks", workload + ".json")

    def family(self, name: str) -> ModuleType:
        return self._module("families", name)

    def reference_family(self, name: str) -> ModuleType:
        return importlib.import_module(f"bench_port.reference.{name}")

    def driver(self, entry: str) -> ModuleType:
        return self._module("drivers", entry)

    def metric(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def metrics_of(self, workload: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
        that list it, and those that list no cells."""
        out = []
        reported_e2e = {m["name"] for m in self.bench["end_to_end"]
                        if "workloads" not in m or workload in m["workloads"]}
        for m in self.bench[kind]:
            if "workloads" in m:
                if workload in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in reported_e2e:
                out.append(m)
        return out
