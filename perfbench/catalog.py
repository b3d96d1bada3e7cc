"""Where the harness finds a cell and everything that belongs to it, by name.

BENCHMARK.json, at the checkout's root, names the cells. A cell names its
configuration and its traffic mix; the configuration's file (its `file`
in BENCHMARK.json, under configs/) names its history generator
(gen/<generator>.py); the mix's data file (traffic/<mix>.json) names its
entry (entries/<entry>.py), the code that holds the corpus in the port's
form and calls the port once a request; each per-layer metric is read by
metrics/<metric>.py. A new cell, configuration, mix, entry or metric is
new files and new entries, and no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

PERFBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PERFBENCH)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """Import the file at `path` as module `name`: file names follow cell
    and metric names, which may hold '-' or '.'."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One cell as the harness runs it: the entries of BENCHMARK.json and
    the files they name."""

    name: str
    chips: int
    config: dict
    mix: dict
    generator: ModuleType
    entry: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files loaded;
    KeyError when the cell is not there."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    generator = load_module(os.path.join(pb, "gen", config["generator"] + ".py"),
                            f"perfbench.gen.{config['generator']}")
    entry = load_module(os.path.join(pb, "entries", mix["entry"] + ".py"),
                        f"perfbench.entries.{mix['entry']}")
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    readers = {m["name"]: load_module(os.path.join(pb, "metrics", m["name"] + ".py"),
                                      f"perfbench.metrics.{m['name']}")
               for m in per_layer}
    return Cell(name, int(cell["chips"]), config, mix, generator, entry, end_to_end,
                per_layer, readers)
