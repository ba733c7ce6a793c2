"""Finds what a cell is made of, by name, in data files.

    BENCHMARK.json                       the cells, the metrics, the bounds
    benchmark/workloads/<cell>.json      a cell's traffic and its driver
    benchmark/configs/<config>.json      a configuration's published sizes
    benchmark/drivers/<driver>.py        one kind of measured window
    benchmark/metrics/<metric>.py        one per-layer metric's reader

A new cell, configuration or metric is a new file under these names and an
entry in ``BENCHMARK.json``; no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


class Manifest:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: Optional[Path] = None, bench_dir: Optional[Path] = None):
        self.root = Path(root) if root is not None else HERE.parent
        self.dir = Path(bench_dir) if bench_dir is not None else HERE
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> Dict:
        """The ``workloads`` entry of ``name`` merged with its traffic file."""
        entries = [w for w in self.spec["workloads"] if w["name"] == name]
        if not entries:
            known = sorted(w["name"] for w in self.spec["workloads"])
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {known}")
        with open(self.dir / "workloads" / f"{name}.json") as f:
            traffic = json.load(f)
        return {**traffic, **entries[0]}

    def config(self, name: str) -> Dict:
        """The configuration file a ``configs`` entry names."""
        entries = [c for c in self.spec["configs"] if c["name"] == name]
        if not entries:
            raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
        with open(self.root / entries[0]["file"]) as f:
            return json.load(f)

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.spec["end_to_end"] if _applies(m, cell)]

    def per_layer(self, cell: str) -> List[Dict]:
        return [m for m in self.spec["per_layer"] if _applies(m, cell)]

    def driver(self, name: str) -> ModuleType:
        return load_module(self.dir / "drivers" / f"{name}.py", f"benchmark_driver_{name}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file at ``path`` as module ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
