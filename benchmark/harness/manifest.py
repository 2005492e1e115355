"""Everything of a cell, found by name: its entry in `BENCHMARK.json`, its
configuration's file (the entry's `file`), its mix's file
(`benchmark/traffic/<mix>.json`) and the readers of its per-layer metrics
(`benchmark/metrics/<metric>.py`, each with `read(records)`). Nothing here
names a cell, a configuration, a mix or a metric."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def _read(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A workload of the manifest under `root` (the checkout)."""

    def __init__(self, root, name: str):
        self.root = Path(root)
        self.manifest = _read(self.root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = by_name[name]
        self.name = name
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = _read(self.root / self.config_entry["file"])
        self.mix = _read(self.root / "benchmark" / "traffic"
                         / f"{self.workload['traffic']}.json")

    def _metrics(self, kind: str) -> list:
        return [m for m in self.manifest[kind]
                if self.name in m.get("workloads", [self.name])]

    @property
    def end_to_end(self) -> list:
        return self._metrics("end_to_end")

    @property
    def per_layer(self) -> list:
        return self._metrics("per_layer")

    def reader(self, metric: str):
        """The `read` function of benchmark/metrics/<metric>.py."""
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
