"""The manifest: cells, configurations, drivers and metric readers are
found by name in files of their own, and BENCHMARK.json keeps to its form."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.manifest import Manifest

from .conftest import CELL, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digest(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_finds_each_piece_by_name():
    m = Manifest()
    cell = m.cell(CELL)
    assert cell["driver"] == "search_bucket" and cell["config"] == "owlvit-b32"
    assert m.config(cell["config"])["vision_config"]["hidden_size"] == 768
    assert hasattr(m.driver(cell["driver"]), "Driver")
    for metric in m.per_layer(CELL):
        assert callable(m.reader(metric["name"]).read)
    with pytest.raises(KeyError):
        m.cell("no-such-cell")


def test_a_new_workload_file_adds_a_cell_without_editing_a_file(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "benchmark")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    new = "owlvit-b32.haystack-b16-sparse"
    spec["workloads"].append({"name": new, "config": "owlvit-b32", "traffic": "haystack-b16-sparse",
                              "chips": 1, "why": "a later cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    wl = json.loads((tmp_path / f"benchmark/workloads/{CELL}.json").read_text())
    wl["mix"].update(videos_per_bucket=16, detector_threshold=10.0)
    (tmp_path / f"benchmark/workloads/{new}.json").write_text(json.dumps(wl))
    (tmp_path / "benchmark/metrics/graph_replays_per_step.py").write_text(
        "def read(record):\n    return None\n")

    m = Manifest(tmp_path, tmp_path / "benchmark")
    assert m.cell(new)["mix"]["videos_per_bucket"] == 16
    assert m.cell(CELL)["mix"]["videos_per_bucket"] == 8
    assert m.reader("graph_replays_per_step").read({}) is None
    after = _digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_keeps_to_its_form():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51 and len(spec["command"]) <= 32
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
    configs = {c["name"]: c for c in spec["configs"]}
    metrics = spec["end_to_end"] + spec["per_layer"]
    for entry in spec["configs"] + spec["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith(tuple(spec["paths"]))
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (REPO / "benchmark/workloads" / f"{w['name']}.json").is_file()
        reported = [m["name"] for m in spec["end_to_end"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in reported and len(reported) >= 2
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert (REPO / "benchmark/metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", [w["name"] for w in spec["workloads"]]):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
