"""BENCHMARK.json and the files it names, found by name.

    workload <cell>   -> perfbench/workloads/<cell>.json  {"entry", ...}
    config <config>   -> perfbench/configs/<config>.json  (the file BENCHMARK.json names)
    traffic <traffic> -> perfbench/traffic/<traffic>.json  (exactly the keys
                         its entry's TRAFFIC names, beside "about")
    per-layer metric  -> perfbench/metrics/<name>.py (read(ctx))
    entry <kind>      -> perfbench/entries/<kind>.py (Cell)

A cell reports every end-to-end metric whose "workloads" list names it (or
that has none), and likewise every per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    entry: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    cell: Dict[str, Any]          # the cell's own file
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell: str, root: Path = ROOT) -> Cell:
    """The cell `cell` of root/BENCHMARK.json with every file it names;
    KeyError for a cell that BENCHMARK.json does not list."""
    manifest = load_json(root / "BENCHMARK.json")
    workloads = {w["name"]: w for w in manifest["workloads"]}
    if cell not in workloads:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = workloads[cell]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    bench = root / "perfbench"
    own = load_json(bench / "workloads" / f"{cell}.json")
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    reads = set(entry_module(own["entry"]).TRAFFIC)
    if set(traffic) - {"about"} != reads:
        raise ValueError(f"traffic {w['traffic']!r} has the keys {sorted(set(traffic) - {'about'})}"
                         f"; the entry {own['entry']!r} reads exactly {sorted(reads)}")
    return Cell(name=cell, chips=int(w["chips"]), entry=own["entry"], config=config,
                traffic=traffic, cell=own,
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, cell)],
                per_layer=[m for m in manifest["per_layer"] if _applies(m, cell)])


def entry_module(kind: str):
    return importlib.import_module(f"perfbench.entries.{kind}")


def metric_reader(name: str):
    return importlib.import_module(f"perfbench.metrics.{name.replace('.', '__')}").read
