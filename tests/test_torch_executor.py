"""The port's BulkReplayExecutor on the CPU: the mechanics of
tests/test_executor.py (ordered results, the depth-N ring, the pack-wait
leg, a pack failure that propagates without a hang, the depth floor), the
same runs through the JAX package's executor for the report and metrics,
and the port's metrics registry and replay profiler against the JAX
package's on the same observations."""
import threading
import time

import numpy as np
import pytest
import torch

from cadence_tpu.engine.executor import BulkReplayExecutor as JExecutor
from cadence_tpu.utils import metrics as jm
from cadence_tpu.utils.profiler import ReplayProfiler as JProfiler
from cadence_tpu_torch.engine.executor import BulkReplayExecutor, pipeline_depth
from cadence_tpu_torch.parallel.mesh import Mesh
from cadence_tpu_torch.utils import metrics as m
from cadence_tpu_torch.utils.profiler import ReplayProfiler


def _run(depth, n_chunks, fail_at=None, registry=None, executor_cls=None):
    log = []
    lock = threading.Lock()
    if executor_cls is None:
        executor = BulkReplayExecutor(depth=depth, registry=registry, device="cpu")
    else:
        executor = executor_cls(depth=depth, registry=registry)

    def pack(ci):
        with lock:
            log.append(("pack", ci))
        if fail_at is not None and ci == fail_at:
            raise ValueError(f"pack {ci} failed")
        return np.full((4,), ci)

    def launch(ci, packed):
        with lock:
            log.append(("launch", ci))
        return packed * 2

    def consume(ci, outs):
        return int(outs.sum())

    outs, report = executor.run(n_chunks, pack, launch, consume)
    return outs, report, log


def test_results_ordered_and_consumed():
    outs, report, _ = _run(depth=3, n_chunks=8)
    assert outs == [ci * 2 * 4 for ci in range(8)]
    assert report.chunks == 8 and report.depth == 3
    assert report.pack_s >= 0 and report.wall_s > 0


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_ring_discipline_depth_n(depth):
    """pack(ci) never starts before chunk ci - depth was launched."""
    _, _, log = _run(depth=depth, n_chunks=2 * depth + 3)
    for ci in range(depth, 2 * depth + 3):
        assert log.index(("launch", ci - depth)) < log.index(("pack", ci)), (depth, ci)


def test_pack_queue_wait_leg_recorded():
    reg = m.MetricsRegistry()
    _run(depth=2, n_chunks=5, registry=reg)
    assert reg.histogram(m.SCOPE_TPU_REPLAY, m.M_PROFILE_PACK_WAIT).count == 5
    assert reg.histogram(m.SCOPE_TPU_REPLAY, m.M_PROFILE_PACK).count == 5
    assert reg.histogram(m.SCOPE_TPU_EXECUTOR, m.M_PROFILE_PACK_WAIT).count == 5
    assert reg.counter(m.SCOPE_TPU_EXECUTOR, m.M_EXEC_CHUNKS) == 5
    assert reg.gauge_value(m.SCOPE_TPU_EXECUTOR, m.M_EXEC_DEVICE_BUSY) == 0.0


def test_same_outputs_and_counts_as_the_jax_executor():
    reg, jreg = m.MetricsRegistry(), jm.MetricsRegistry()
    outs, report, _ = _run(depth=3, n_chunks=7, registry=reg)
    jouts, jreport, _ = _run(depth=3, n_chunks=7, registry=jreg, executor_cls=JExecutor)
    assert outs == jouts
    assert (report.chunks, report.depth) == (jreport.chunks, jreport.depth)
    for scope, name in ((m.SCOPE_TPU_REPLAY, m.M_PROFILE_PACK),
                        (m.SCOPE_TPU_REPLAY, m.M_PROFILE_PACK_WAIT),
                        (m.SCOPE_TPU_EXECUTOR, m.M_PROFILE_PACK_WAIT)):
        assert reg.histogram(scope, name).count == jreg.histogram(scope, name).count
    assert (reg.counter(m.SCOPE_TPU_EXECUTOR, m.M_EXEC_CHUNKS)
            == jreg.counter(jm.SCOPE_TPU_EXECUTOR, jm.M_EXEC_CHUNKS))


def test_pack_failure_propagates_without_hang():
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="pack 2 failed"):
        _run(depth=2, n_chunks=6, fail_at=2)
    assert time.monotonic() - t0 < 30  # the pool must not wedge


def test_launch_failure_propagates_without_hang():
    executor = BulkReplayExecutor(depth=2, registry=m.MetricsRegistry(), device="cpu")

    def launch(ci, packed):
        if ci == 1:
            raise RuntimeError("launch 1 failed")
        return packed

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="launch 1 failed"):
        executor.run(6, lambda ci: ci, launch, lambda ci, out: out)
    assert time.monotonic() - t0 < 30


def test_pipeline_depth_floor(monkeypatch):
    assert pipeline_depth(1) == 2
    assert pipeline_depth(5) == 5
    monkeypatch.setenv("CADENCE_TPU_PIPELINE_DEPTH", "6")
    assert pipeline_depth() == 6 == BulkReplayExecutor(device="cpu").depth


def test_cpu_launches_need_no_marker():
    """On the CPU a launch has finished when it returns; on the card the
    executor records a CUDA event per device slice after each launch and
    the ring waits on them. No device named means the card."""
    assert BulkReplayExecutor(device="cpu")._launched_markers() == []
    assert BulkReplayExecutor(mesh=Mesh(["cpu", "cpu"]))._launched_markers() == []


def test_no_device_named_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        BulkReplayExecutor()


# ---------------------------------------------------------------------------
# utils/metrics.py and utils/profiler.py against the JAX package's
# ---------------------------------------------------------------------------


def _observations():
    rng = np.random.default_rng(7)
    return [float(x) for x in rng.lognormal(-5, 2, 200)]


def test_histogram_percentiles_equal_the_jax_registry():
    reg, jreg = m.MetricsRegistry(), jm.MetricsRegistry()
    for v in _observations():
        for r in (reg, jreg):
            r.observe("s", "leg", v)
            r.record("s", "timer", v)
            r.observe("s", "bytes", v * 1e9, buckets=m.BYTE_BUCKETS)
    for name in ("leg", "timer", "bytes"):
        h, jh = reg.histogram("s", name), jreg.histogram("s", name)
        assert (h.count, h.bounds, h.bucket_counts) == (jh.count, jh.bounds, jh.bucket_counts)
        assert [h.percentile(q) for q in (0.5, 0.95, 0.99)] == \
            [jh.percentile(q) for q in (0.5, 0.95, 0.99)]
    assert reg.snapshot() == jreg.snapshot()
    t, jt = reg.timer("s", "timer"), jreg.timer("s", "timer")
    assert (t.count, t.total_s, t.max_s) == (jt.count, jt.total_s, jt.max_s)
    reg.reset()
    assert reg.snapshot() == {}


def test_scope_handles():
    reg = m.MetricsRegistry()
    sc = reg.scope(m.SCOPE_REBUILD)
    sc.inc(m.M_DEVICE_REBUILDS, 3)
    sc.gauge(m.M_FALLBACK_RATE, 0.25)
    with sc.timed():
        pass
    assert reg.counter(m.SCOPE_REBUILD, m.M_DEVICE_REBUILDS) == 3
    assert reg.gauge_value(m.SCOPE_REBUILD, m.M_FALLBACK_RATE) == 0.25
    assert reg.timer(m.SCOPE_REBUILD, m.M_LATENCY).count == 1


def test_metric_names_are_the_jax_package_names():
    for name in ("SCOPE_TPU_REPLAY", "SCOPE_REBUILD", "SCOPE_TPU_FALLBACK", "SCOPE_TPU_EXECUTOR",
                 "SCOPE_TPU_NATIVE", "M_KERNEL_LAUNCHES", "M_EVENTS_REPLAYED",
                 "M_DEVICE_REBUILDS", "M_ORACLE_FALLBACKS", "M_FALLBACK_RATE",
                 "M_PROFILE_PACK", "M_PROFILE_H2D", "M_PROFILE_KERNEL", "M_PROFILE_READBACK",
                 "M_PROFILE_PACK_WAIT", "M_PROFILE_FALLBACK", "M_PROFILE_SERVING",
                 "M_H2D_BYTES", "M_EXEC_CHUNKS", "M_EXEC_DEVICE_BUSY", "M_LATENCY"):
        assert getattr(m, name) == getattr(jm, name), name
    assert m.DEFAULT_BUCKETS == jm.DEFAULT_BUCKETS and m.BYTE_BUCKETS == jm.BYTE_BUCKETS


def test_profiler_summary_equals_the_jax_profiler():
    reg, jreg = m.MetricsRegistry(), jm.MetricsRegistry()
    p, jp = ReplayProfiler(reg, m.SCOPE_REBUILD), JProfiler(jreg, jm.SCOPE_REBUILD)
    for v in _observations()[:40]:
        for prof in (p, jp):
            prof.observe(m.M_PROFILE_KERNEL, v)
            prof.h2d(int(v * 1e9))
    reg.inc(m.SCOPE_REBUILD, m.M_KERNEL_LAUNCHES, 4)
    jreg.inc(jm.SCOPE_REBUILD, jm.M_KERNEL_LAUNCHES, 4)
    with p.leg(m.M_PROFILE_READBACK):
        pass
    with jp.leg(jm.M_PROFILE_READBACK):
        pass
    got, want = p.summary(), jp.summary()
    assert got.keys() == want.keys()
    for k in ("scope", "kernel_launches", "h2d_bytes", m.M_PROFILE_KERNEL):
        assert got[k] == want[k], k
    assert got[m.M_PROFILE_READBACK]["count"] == 1
