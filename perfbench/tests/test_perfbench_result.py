"""The result line: its keys, in order, and what each holds."""
import json
import math
import os
import subprocess
import sys

from perfbench.catalog import ROOT

from .conftest import run_tiny


def _number(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x)


def test_result_line_schema(tiny):
    for trace in (False, True):
        result, lines = run_tiny(tiny, trace=trace)
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        keys += ["breakdown", "checks"] if trace else ["checks"]
        assert list(result) == keys
        assert result["correct"] is True and result["failed"] == 0
        assert isinstance(result["attempted"], int) and result["attempted"] > 0
        assert result["metrics"]
        for m in result["metrics"].values():
            assert set(m) == {"value", "unit"} and _number(m["value"])
        dev = result["device"]
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
        if trace:
            assert _number(dev["busy_s"]) and dev["window_s"] > 0
            for key in ("device_ops", "idle_gaps"):
                assert len(result["breakdown"][key]) <= 10
        for c in result["checks"].values():
            assert set(c) == {"value", "limit"}
        assert [ln.split(":")[0] for ln in lines[-1:]] == [f"check {n}" for n in result["checks"]]
        json.dumps(result)


def test_without_a_card_the_command_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, os.path.join("perfbench", "run.py"), "--workload",
                        "bench-basic.wire32", "--seed", str(2**33), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA card" in p.stderr
