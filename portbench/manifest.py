"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

A configuration is the file its ``configs`` entry names; a traffic mix is
``traffic/<name>.json`` beside this file; a per-layer metric is
``metrics/<name>.py``, whose ``read(trace)`` returns its value or None.
Adding a configuration, a mix, a metric or a cell adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.bench["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics a traced run of ``cell`` reports: those whose
        ``workloads`` list it. Every per-layer metric lists its cells."""
        for m in self.bench["per_layer"]:
            if "workloads" not in m:
                raise KeyError(f"per-layer metric {m['name']!r} lists no workloads")
        return [m for m in self.bench["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def spans(self) -> list:
        return json.loads((self.dir / "spans.json").read_text())
