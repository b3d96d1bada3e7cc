"""The trace's reduction and the per-layer readers, on a made-up trace."""
import pytest

from perfbench.catalog import PERFBENCH, load_module
from perfbench.harness import Reading
from perfbench.tracing import reduce_chrome_trace
from perfbench.window import Window


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


DOC = {"traceEvents": [
    _x("perfbench.window", "user_annotation", 1000.0, 1000.0),
    _x("void ns::replay_kernel<1, false>(x)", "kernel", 1100.0, 100.0),
    _x("ns::payload_kernel(y)", "kernel", 1150.0, 150.0),
    _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1500.0, 100.0),
    _x("void (anonymous namespace)::crc32_kernel<4>(z)", "kernel", 1650.0, 50.0),
    _x("aten::full", "cpu_op", 1300.0, 20.0),
    _x("perfbench.dispatch", "user_annotation", 1310.0, 170.0),
    _x("aten::zeros", "cpu_op", 1390.0, 30.0),
    _x("outside", "kernel", 5000.0, 10.0),
    {"ph": "i", "name": "marker", "ts": 1200.0},
]}


def test_busy_idle_and_kernels():
    t = reduce_chrome_trace(DOC)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_intervals() == [(1100.0, 1300.0), (1500.0, 1600.0), (1650.0, 1700.0)]
    assert t.busy_s == pytest.approx(350e-6)
    assert t.kernel_seconds(r"\breplay_kernel\b") == pytest.approx(100e-6)
    assert t.kernel_seconds(r"\b(payload_kernel|crc32_kernel)\b") == pytest.approx(200e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::zeros"] == pytest.approx(200e-6)  # innermost at the gap's middle
    assert gaps["host idle"] == pytest.approx(450e-6)
    assert t.device_ops()[0] == ["ns::payload_kernel(y)", pytest.approx(150e-6)]


def test_the_readers():
    t = reduce_chrome_trace(DOC)
    win = Window(requests=4, events=4000, bytes=0, seconds=1.0, dispatch_s=0.002,
                 latencies_s=[i * 1e-3 for i in range(1, 21)])
    traced = Window(requests=2, events=2_000_000, bytes=335_000)
    r = Reading(None, win, traced, t)

    def read(name, reading=r):
        return load_module(f"{PERFBENCH}/metrics/{name}.py", f"m_{name}").read(reading)

    assert read("dispatch_ms_per_request") == pytest.approx(0.5)
    assert read("dispatch_paced_events_per_s") == pytest.approx(4000.0)
    assert read("launches_per_request") == pytest.approx(2.0)
    assert read("replay_roofline") == pytest.approx(100.0 * (335_000 / 3.35e12) / 100e-6)
    assert read("hash_ms_per_gevent") == pytest.approx(0.2 / 2e-3)
    assert read("device_idle_pct") == pytest.approx(65.0)
    empty = Reading(None, win, Window(), None)
    assert [read(n, empty) for n in ("launches_per_request", "replay_roofline", "hash_ms_per_gevent",
                              "device_idle_pct")] == [None] * 4
    assert read("dispatch_paced_events_per_s", Reading(None, Window(), None, None)) is None
