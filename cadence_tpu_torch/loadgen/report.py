"""LOADGEN_r0N.json latency trajectory files.

The loadgen's analog of the BENCH_r*.json trajectory: one JSON document
per recorded run, numbered r01, r02, ... next to the bench files, so
the latency story (p50/p99/p999 per op per domain, shed/admit counts,
SLO verdicts, checksum-verify outcome) accretes run over run the same
way the throughput story does.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

_PATTERN = re.compile(r"LOADGEN_r(\d+)\.json$")
SCHEMA = "loadgen-trajectory-v1"


def latest_trajectory_path(root: str = ".") -> Optional[str]:
    runs = sorted(
        (int(mo.group(1)), name)
        for name in os.listdir(root)
        for mo in [_PATTERN.match(name)] if mo)
    return os.path.join(root, runs[-1][1]) if runs else None


def next_trajectory_path(root: str = ".") -> str:
    latest = latest_trajectory_path(root)
    n = 0
    if latest is not None:
        n = int(_PATTERN.match(os.path.basename(latest)).group(1))
    return os.path.join(root, f"LOADGEN_r{n + 1:02d}.json")


def write_trajectory(doc: dict, root: str = ".",
                     path: Optional[str] = None) -> str:
    """Write one run's document (schema-stamped) to `path` or the next
    free LOADGEN_r0N.json slot under `root`; returns the path."""
    doc = {"schema": SCHEMA, **doc}
    out = path or next_trajectory_path(root)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return out
