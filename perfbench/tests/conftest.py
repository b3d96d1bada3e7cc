"""A tiny cell in a temporary copy of the benchmark, for runs on the CPU.

`tiny_root(tmp, entry)` copies perfbench/ beside a BENCHMARK.json that
adds a configuration of 256 short basic histories, cut in blocks of 64,
and a mix of 64-workflow chunks over the entry `entry`; `run_tiny` runs that cell through the
harness on the CPU, where the port's entries run their plain versions.
"""
import json
import os
import shutil
import time

import pytest

from perfbench.catalog import PERFBENCH, ROOT, find_cell

TINY = "tiny.cell"


def tiny_root(tmp, entry: str = "wire32") -> str:
    root = str(tmp)
    shutil.copytree(PERFBENCH, os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(PERFBENCH, "configs", "bench-basic.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", workflows=256, target_events=21, cut_block=64)
    with open(os.path.join(root, "perfbench", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    mix = {"entry": entry, "chunk_workflows": 64, "depth": 2}
    with open(os.path.join(root, "perfbench", "traffic", "tiny-mix.json"), "w") as f:
        json.dump(mix, f)
    bench["configs"].append({"name": "tiny", "source": "test", "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": TINY, "config": "tiny", "traffic": "tiny-mix", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_tiny(root: str, trace: bool = False, seed: int = 2**31 + 11, seconds: float = 0.5,
             device: str = "cpu", cell=None):
    from perfbench.harness import run_cell

    cell = cell or find_cell(TINY, root)
    return run_cell(cell, seed, seconds, trace, time.perf_counter(), device)


@pytest.fixture(params=["wire32", "wirec"])
def tiny(request, tmp_path):
    return tiny_root(tmp_path, request.param)
