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
hands its tiers) and the comments that cite the JAX package's review
history, reworded; both are listed here."""
import re
from pathlib import Path

import pytest

from tests.torch_parity import ported_reference


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
#: methods of the kept classes that test a module the port has not taken yet
#: (rpc/, ROADMAP queue A)
WAITS_FOR_RPC = ("TestRetryPolicy.test_non_retriable_classification",
                 "TestRetryPolicy.test_request_idempotency_classification",
                 "TestTracing.test_wire_envelope_round_trip")

globals().update(ported_reference("test_resilience.py", classes=("TestRetryPolicy",),
                                  tag="resilience", leave_out=WAITS_FOR_RPC))
globals().update(ported_reference(
    "test_observability.py", classes=("TestHistogram", "TestPrometheus", "TestTracing",
                                      "TestOneboxTraces", "TestScrapeSurface"),
    tag="observability", leave_out=WAITS_FOR_RPC))
globals().update(ported_reference(
    "test_telemetry.py", classes=("TestTimeSeriesSampler", "TestHostProfiler",
                                  "TestScrapeConsistency", "TestTelemetryScrapeSurface"),
    tag="telemetry"))


# -- drift: the copied modules are the JAX package's ---------------------------

ROOT = Path(__file__).resolve().parent.parent
COPIED = ("utils/log", "utils/backoff", "utils/dynamicconfig", "utils/tracing", "oracle/retry",
          "engine/cluster", "engine/limits", "engine/pagination", "engine/faults",
          "engine/notifier", "engine/query", "engine/checker", "engine/archival",
          "engine/domain", "engine/authorization", "engine/tasks", "engine/shard",
          "engine/task_refresher", "engine/crosscluster", "engine/history_engine",
          "engine/controller", "engine/matching", "engine/queues", "engine/frontend",
          "engine/workers", "utils/timeseries", "utils/hostprof", "utils/scrape",
          "engine/onebox", "models/__init__", "models/deciders")
#: the port's own hunks, as (the JAX text, the port's text): the device the
#: Onebox resolves once and hands to every tier and engine
PORT_HUNKS = {
    "engine/history_engine": (
        ("        self.serving = None\n",
         "        self.serving = None\n"
         "        #: where this engine's own device work runs (the reset rebuilder it\n"
         "        #: builds when the cluster wires none); None = the card. The owning\n"
         "        #: cluster sets it (onebox._make_engine)\n"
         "        self.device = None\n"),
        ("            self.rebuilder = DeviceRebuilder(self.config.payload_layout())\n",
         "            self.rebuilder = DeviceRebuilder(self.config.payload_layout(),\n"
         "                                             device=self.device)\n"),
    ),
    "engine/onebox": (
        ("hop); queue processors and a manual clock drive progress deterministically.\n",
         "hop); queue processors and a manual clock drive progress deterministically.\n"
         "\n"
         "The device tier (the bulk verify engine, the reset rebuilder, the serving\n"
         "scheduler and the visibility view) runs on one device, resolved once at\n"
         "construction: None means the card, and without one construction raises;\n"
         "the CPU is used only when the caller names it.\n"),
        ("from ..utils.clock import ManualTimeSource\n",
         "from ..device import resolve_device\nfrom ..utils.clock import ManualTimeSource\n"),
        ("config=None, time_source=None) -> None:\n",
         "config=None, time_source=None, device=None) -> None:\n"),
        ("        self.stores = stores if stores is not None else Stores()\n",
         "        self.stores = stores if stores is not None else Stores()\n"
         "        #: the one device every device tier of this cluster runs on\n"
         "        self.device = resolve_device(device)\n"),
        ("TPUReplayEngine(self.stores, layout)\n",
         "TPUReplayEngine(self.stores, layout, device=self.device)\n"),
        ("DeviceRebuilder(layout)\n", "DeviceRebuilder(layout, device=self.device)\n"),
        ("        self.stores.visibility.metrics = self.metrics\n",
         "        self.stores.visibility.metrics = self.metrics\n"
         "        self.stores.visibility.device = self.device\n"),
        ("        engine = HistoryEngine(shard, self.stores, self.clock)\n",
         "        engine = HistoryEngine(shard, self.stores, self.clock)\n"
         "        engine.device = self.device\n"),
    ),
}


#: comments of the JAX modules that cite its review history, reworded in the
#: port's copies: (module, the JAX file's first and last line, the port's text)
REWORDED = (
    ('utils/dynamicconfig', 150, 151,
     '        """The kernel capacities as a PayloadLayout — tunable without code\n'
     '        edits."""'),
    ('engine/notifier', 11, 11,
     'the process) as a single global condvar would.'),
    ('engine/authorization', 8, 8,
     'longer structurally wide open."""'),
    ('engine/tasks', 11, 12,
     "These are the active side's scale machinery (a single-threaded pump\n"
     "would be the scalability ceiling). The executors overlap"),
    ('engine/tasks', 122, 122,
     '        #: redispatch)'),
    ('engine/history_engine', 1747, 1747,
     '        # COMMITTED batch → device-serving tier: the'),
    ('engine/matching', 10, 10,
     'Fidelity to the reference:'),
    ('engine/queues', 180, 182,
     '        gone) — counted so the drops are visible, never swallowed\n        invisibly."""'),
    ('engine/onebox', 73, 74,
     '        # kernel capacities come from dynamic config (tunable without code\n'
     '        # edits)'),
)


def import_rewrite(text: str) -> str:
    return re.sub(r"\bcadence_tpu\b", "cadence_tpu_torch", text)


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_the_jax_one(module):
    lines = (ROOT / "cadence_tpu" / f"{module}.py").read_text().split("\n")
    for m, first, last, port_text in sorted(REWORDED, key=lambda r: -r[1]):
        if m == module:
            lines[first - 1:last] = port_text.split("\n")
    want = import_rewrite("\n".join(lines))
    for jax_text, port_text in PORT_HUNKS.get(module, ()):
        assert want.count(jax_text) == 1, jax_text
        want = want.replace(jax_text, port_text)
    assert (ROOT / "cadence_tpu_torch" / f"{module}.py").read_text() == want


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
