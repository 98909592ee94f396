"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A configuration is the file ``BENCHMARK.json`` gives for it, a cell's
traffic is ``portbench/workloads/<cell>.json``, and a per-layer metric is
read by ``portbench/metrics/<metric>.py``'s ``read(run)``. The harness
finds each by its name, so a later cell, configuration or metric is one
more file and one more entry in ``BENCHMARK.json``, and no file that is
there changes.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

PACKAGE = "portbench"


class Bench:
    """``BENCHMARK.json`` at ``root`` and the benchmark's files under it."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self._cells = {w["name"]: w for w in self.doc["workloads"]}
        self._configs = {c["name"]: c for c in self.doc["configs"]}

    def cell(self, name: str) -> dict:
        """The cell's entry in ``BENCHMARK.json`` merged with its traffic
        file's parameters."""
        if name not in self._cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(it has {sorted(self._cells)})")
        path = self.root / PACKAGE / "workloads" / f"{name}.json"
        return {**json.loads(path.read_text()), **self._cells[name]}

    def config(self, name: str) -> dict:
        """The configuration file's contents, as it is run."""
        return json.loads((self.root / self._configs[name]["file"])
                          .read_text())

    def _applies(self, metric: dict, cell: str) -> bool:
        return cell in metric.get("workloads", (cell,))

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.doc["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.doc["per_layer"] if self._applies(m, cell)]

    def reader(self, metric: str):
        """``read`` of ``portbench/metrics/<metric>.py``, loaded by path
        (a metric's name may hold dots)."""
        path = self.root / PACKAGE / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"{PACKAGE}_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
