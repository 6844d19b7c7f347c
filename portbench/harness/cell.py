"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:

- ``configs[].file``: the configuration, as it is run;
- ``portbench/traffic/<traffic>.json``: the traffic mix, whose ``kind``
  names its driver, ``portbench/harness/kinds/<kind>.py``;
- ``portbench/limits/<workload>.json``: the limit of each number that the
  correctness check compares;
- ``portbench/metrics/<metric>.py``: the reader of each per-layer metric.

A later cell, mix or metric is added as files and entries, without an edit.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, manifest: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = _load_json(manifest)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {manifest.name}; it "
                         f"has {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _listed(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _listed(m, workload) and m["moves"] in names]
    return Cell(workload, w["chips"], w["config"], w["traffic"],
                _load_json(ROOT / cfg["file"]),
                _load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                _load_json(BENCH / "limits" / f"{workload}.json"),
                e2e, per_layer)


def reader(metric: str):
    """The ``read(cell, outcome)`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
