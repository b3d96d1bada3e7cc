"""A new configuration, mix and metric are new files and entries only."""
import hashlib
import json
import os

from perfbench.catalog import PERFBENCH, find_cell

from .conftest import TINY, run_tiny, tiny_root


def _digests(folder):
    out = {}
    for base, dirs, files in os.walk(folder):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, folder)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_dummy_config_mix_and_metric_run_with_no_file_edited(tmp_path):
    root = tiny_root(tmp_path, "wire32")
    before = _digests(PERFBENCH)
    copied = _digests(os.path.join(root, "perfbench"))
    with open(os.path.join(root, "perfbench", "metrics", "dummy_requests.py"), "w") as f:
        f.write("def read(reading):\n    return float(reading.traced.requests)\n")
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "dummy_requests", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves":
                               "verify_events_per_s", "workloads": [TINY]})
    bench["end_to_end"].append({"name": "verify_events_per_s.dummy", "unit": "events/s",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": [TINY]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)

    cell = find_cell(TINY, root)
    assert cell.config["name"] == "tiny" and cell.mix["chunk_workflows"] == 64
    result, _ = run_tiny(root, trace=True)
    assert result["correct"] is True
    assert result["metrics"]["dummy_requests"]["value"] > 0
    assert result["metrics"]["dummy_requests"]["unit"] == "requests"
    result, _ = run_tiny(root, trace=False)
    metrics = result["metrics"]
    assert {"verify_events_per_s.dummy", "setup_s"} <= set(metrics)
    assert metrics["verify_events_per_s.dummy"] == metrics[
        next(m["name"] for m in cell.end_to_end if m["name"].startswith("verify_events_per_s")
             and m["name"] != "verify_events_per_s.dummy")]
    assert _digests(PERFBENCH) == before
    for rel, digest in copied.items():
        assert _digests(os.path.join(root, "perfbench"))[rel] == digest


def test_every_cell_of_the_benchmark_is_found():
    from perfbench.catalog import load_benchmark

    bench = load_benchmark()
    for w in bench["workloads"]:
        cell = find_cell(w["name"])
        assert cell.entry.prepare and cell.generator.template
        assert {m["name"] for m in cell.per_layer} == set(cell.readers)


def test_every_cell_reports_what_its_per_layer_metrics_move():
    from perfbench.catalog import load_benchmark

    bench = load_benchmark()
    for w in bench["workloads"]:
        cell = find_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
