"""The modules the Onebox brought into the port (cadence_tpu_torch/engine/
{cluster,limits,pagination,faults,notifier,query,checker,archival,domain,
authorization,tasks,shard,task_refresher,crosscluster,history_engine,
controller,matching,queues,frontend,workers,onebox}.py, utils/{log,backoff,
dynamicconfig,tracing,timeseries,hostprof,scrape}.py, oracle/retry.py and
models/) held to the JAX package's.

Two kinds of test. The reference's own test classes, run against the port:
tests/torch_parity.py ported_reference points each file's imports at
cadence_tpu_torch and builds each Onebox on the CPU (the JAX package runs
the same classes in their own files). And a drift test: each copied
module's text equals the JAX module's once `cadence_tpu` reads
`cadence_tpu_torch`, except the port's own hunks (the device the Onebox
hands its tiers, and the comments that cite the JAX package's review
history, reworded), kept as unified diffs in tests/torch_hunks/
(tests/torch_port_drift.py)."""
import re

import pytest

from tests.torch_parity import ported_reference
from tests.torch_port_drift import assert_port_text


@pytest.fixture(autouse=True)
def _fresh_port_globals():
    """What tests/conftest.py resets for the JAX package, for the port: the
    default registry and tracer, the quota limiters, the telemetry plane,
    and every serving drain thread and resident slab."""
    from cadence_tpu_torch.engine import resident, serving, visibility_device
    from cadence_tpu_torch.utils import (flightrecorder, hostprof, metrics, quotas, timeseries,
                                         tracing)

    metrics.DEFAULT_REGISTRY.reset()
    tracing.DEFAULT_TRACER.reset()
    quotas.reset_all()
    flightrecorder.reset_all()
    hostprof.reset_all()
    timeseries.reset_all()
    yield
    serving.reset_all()
    resident.reset_all()
    visibility_device.reset_all()


# -- the reference's own classes against the port ----------------------------

globals().update(ported_reference("test_matching.py", tag="matching"))
globals().update(ported_reference("test_decision_checker.py", tag="checker"))
globals().update(ported_reference("test_limits_pagination.py", tag="limits"))
globals().update(ported_reference("test_query.py", tag="query"))
globals().update(ported_reference("test_longpoll.py", tag="longpoll"))
globals().update(ported_reference("test_archival.py", tag="archival"))
globals().update(ported_reference("test_migration.py", classes=("TestControllerHooks",),
                                  tag="migration"))
globals().update(ported_reference("test_resilience.py", classes=("TestRetryPolicy",),
                                  tag="resilience"))
globals().update(ported_reference(
    "test_observability.py", classes=("TestHistogram", "TestPrometheus", "TestTracing",
                                      "TestOneboxTraces", "TestScrapeSurface"),
    tag="observability"))
globals().update(ported_reference(
    "test_telemetry.py", classes=("TestTimeSeriesSampler", "TestHostProfiler",
                                  "TestScrapeConsistency", "TestTelemetryScrapeSurface"),
    tag="telemetry"))


# -- drift: the copied modules are the JAX package's ---------------------------

COPIED = ("utils/log", "utils/backoff", "utils/dynamicconfig", "utils/tracing", "oracle/retry",
          "engine/cluster", "engine/limits", "engine/pagination", "engine/faults",
          "engine/notifier", "engine/query", "engine/checker", "engine/archival",
          "engine/domain", "engine/authorization", "engine/tasks", "engine/shard",
          "engine/task_refresher", "engine/crosscluster", "engine/history_engine",
          "engine/controller", "engine/matching", "engine/queues", "engine/frontend",
          "engine/workers", "utils/timeseries", "utils/hostprof", "utils/scrape",
          "engine/onebox", "models/__init__", "models/deciders")
@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_the_jax_one(module):
    assert_port_text(module)


def test_metrics_carry_every_jax_name():
    """utils/metrics.py is the port's own text; it must hold every scope and
    metric name of the JAX registry with the same string, less the
    kernel-variant cache's (the port has none), and its four emitter
    methods."""
    from cadence_tpu.utils import metrics as jax_m
    from cadence_tpu_torch.utils import metrics as port_m

    no_variant_cache = {"M_LADDER_CACHE_HITS", "M_LADDER_CACHE_MISSES", "M_LADDER_COMPILES"}
    names = {n for n in dir(jax_m) if re.fullmatch(r"(SCOPE|M)_[A-Z0-9_]+", n)}
    missing = {n for n in names - no_variant_cache
               if getattr(port_m, n, None) != getattr(jax_m, n)}
    assert not missing
    assert not no_variant_cache & set(dir(port_m))
    assert port_m.domain_metric("shed", "hot") == jax_m.domain_metric("shed", "hot")
    for method in ("cumulative",):
        assert hasattr(port_m.HistogramStat, method)
    for method in ("percentiles", "raw_series", "to_prometheus"):
        assert hasattr(port_m.MetricsRegistry, method)


@pytest.mark.parametrize("case", ("counters", "histogram", "gauges", "empty"))
def test_prometheus_text_equals_jax(case):
    from cadence_tpu.utils import metrics as jax_m
    from cadence_tpu_torch.utils import metrics as port_m

    def fill(r):
        if case in ("counters", "gauges"):
            r.inc("frontend.start-workflow-execution", "requests", 3)
            r.inc("quotas", "shed-domain-a.b", 1)
        if case == "gauges":
            r.gauge("tpu.resident", "resident-bytes", 1024.0)
            r.gauge("host.prof", "attributed-share", 0.925)
        if case == "histogram":
            for v in (0.0004, 0.003, 0.2, 7.0, 42.0):
                r.record("history.signal-workflow-execution", "latency", v)
            r.observe("tpu.executor", "h2d-bytes", 5e6, buckets=port_m.BYTE_BUCKETS)
        return r.to_prometheus(), r.percentiles("history.signal-workflow-execution", "latency")

    assert fill(port_m.MetricsRegistry()) == fill(jax_m.MetricsRegistry())
