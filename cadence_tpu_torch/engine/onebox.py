"""Onebox: a full multi-host cluster in one process.

Reference: host/onebox.go:76 — the integration-test backbone that runs
history/matching/frontend together against real stores with a static
membership resolver (host/membership_resolver.go:36-69). Here: N virtual
history hosts share one store bundle; the hashring assigns shards to hosts;
a cluster-wide router forwards cross-host calls (standing in for the gRPC
hop); queue processors and a manual clock drive progress deterministically.

The device tier (the bulk verify engine, the reset rebuilder, the serving
scheduler and the visibility view) runs on one device, resolved once at
construction: None means the card, and without one construction raises;
the CPU is used only when the caller names it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..device import resolve_device
from ..utils.clock import ManualTimeSource
from .controller import ShardController, ShardNotOwnedError
from .frontend import Frontend
from .history_engine import HistoryEngine
from .matching import MatchingEngine
from .membership import HashRing
from .persistence import Stores
from .queues import QueueProcessors
from .tpu_engine import TPUReplayEngine

NANOS = 1_000_000_000


class Onebox:
    def __init__(self, num_hosts: int = 2, num_shards: int = 8,
                 cluster_name: str = "primary",
                 stores: Optional[Stores] = None,
                 config=None, time_source=None, device=None) -> None:
        from ..utils.dynamicconfig import DynamicConfig
        from ..utils.metrics import MetricsRegistry
        #: injected stores = durable bundle (crash recovery) or a shared
        #: bundle; default = fresh in-memory cluster
        self.stores = stores if stores is not None else Stores()
        #: the one device every device tier of this cluster runs on
        self.device = resolve_device(device)
        #: tests drive the default manual clock; real deployments (the
        #: CLI) inject RealTimeSource so timers/retention actually elapse
        self.clock = time_source if time_source is not None else ManualTimeSource()
        #: runtime knobs (common/dynamicconfig analog) + cluster metrics
        self.config = config if config is not None else DynamicConfig()
        self.metrics = MetricsRegistry()
        #: the shared tracer (traced components default to it; tests read
        #: box.tracer.traces() for stitched frontend→history→matching calls)
        from ..utils import tracing
        self.tracer = tracing.DEFAULT_TRACER
        # authorization seam (authorizer.go:88): Noop unless the operator
        # wires a real authorizer; AdminHandler and the frontend consult it
        from .authorization import NoopAuthorizer
        self.authorizer = NoopAuthorizer()
        self.cluster_name = cluster_name
        self.num_shards = num_shards
        #: shared across every engine this cluster creates
        self._publisher_holder = {"pub": None}
        self.hosts = [f"host-{i}" for i in range(num_hosts)]
        self.ring = HashRing(self.hosts)
        self.controllers: Dict[str, ShardController] = {
            h: ShardController(h, num_shards, self.stores, self.ring, self.clock,
                               engine_factory=self._make_engine)
            for h in self.hosts
        }
        self.matching = MatchingEngine(self.stores, config=self.config)
        self.processors = [
            QueueProcessors(c, self.matching, self.stores, self.clock,
                            router=self.route, metrics=self.metrics,
                            config=self.config, cluster_name=cluster_name)
            for c in self.controllers.values()
        ]
        self.frontend = Frontend(self.stores, self.matching, self.route,
                                 config=self.config, metrics=self.metrics,
                                 time_source=self.clock,
                                 cluster_name=cluster_name)
        # kernel capacities come from dynamic config (tunable without code
        # edits)
        layout = self.config.payload_layout()
        self.tpu = TPUReplayEngine(self.stores, layout, device=self.device)
        self.tpu.metrics = self.metrics
        # one device rebuilder shared by every engine this box creates and
        # (via multicluster wiring) the replicator applying INTO this box,
        # so box.rebuilder.stats counts that whole cluster's device vs
        # oracle rebuilds; standalone recovery (durability.recover_stores)
        # reports its own counts in RecoveryReport instead
        from .rebuild import DeviceRebuilder
        self.rebuilder = DeviceRebuilder(layout, device=self.device)
        self.rebuilder.metrics = self.metrics
        # the rebuilder consults the SAME resident-state cache verify_all
        # seeds: a rebuild of a cached workflow replays only its appended
        # batches (engine/resident.py), packed through the engine's pack
        # cache so the host side is O(suffix) too
        self.rebuilder.resident = self.tpu.resident
        self.rebuilder.pack_cache = self.tpu.pack_cache
        # the rebuilder also consults the durable snapshot tier
        # (engine/snapshot.py): a reset/recovery rebuild of a
        # snapshotted workflow hydrates + replays only the suffix
        self.rebuilder.snapshots = self.stores.snapshot
        # one consistent-query registry for the cluster (shard movement
        # within the box keeps waiters reachable)
        from .query import QueryRegistry
        self.query_registry = QueryRegistry()
        from .notifier import HistoryNotifier
        self.notifier = HistoryNotifier()
        # system workers (service/worker analogs); a host loop or test
        # drives run_once() passes
        from .workers import ExecutionScanner, RetentionScavenger
        self.scavenger = RetentionScavenger(self.stores, self.route,
                                            self.clock, self.metrics)
        self.scanner = ExecutionScanner(self.stores, self.tpu, self.metrics)
        # device-serving transaction tier (engine/serving.py): wired into
        # every engine this box creates when CADENCE_TPU_SERVING=1 —
        # committed transactions micro-batch into from-state launches on
        # the SAME resident pool verify_all serves from
        from . import serving as serving_mod
        self.serving = (self.tpu.serving_scheduler()
                        if serving_mod.enabled() else None)
        # columnar device visibility tier (engine/visibility_device.py,
        # CADENCE_TPU_VISIBILITY=1): the store creates its device twin
        # lazily on the first routed List/Scan/Count — point its
        # tpu.visibility series at this cluster's registry, and
        # pre-register them so a scrape always distinguishes "zero
        # divergences" from "series missing" (the serving-tier contract)
        self.stores.visibility.metrics = self.metrics
        self.stores.visibility.device = self.device
        from ..utils import metrics as cm
        for metric in (cm.M_VIS_QUERIES, cm.M_VIS_DEVICE_SERVED,
                       cm.M_VIS_HOST_FALLBACKS,
                       cm.M_VIS_FALLBACK_PREDICATE,
                       cm.M_VIS_FALLBACK_COLUMN, cm.M_VIS_PARITY_CHECKS,
                       cm.M_VIS_DIVERGENCE, cm.M_VIS_DELTAS,
                       cm.M_VIS_DRAINS, cm.M_VIS_TOPK, cm.M_VIS_BITMAP,
                       cm.M_VIS_TOPK_ESCALATIONS,
                       cm.M_VIS_ATTR_REPLACEMENTS):
            self.metrics.inc(cm.SCOPE_TPU_VISIBILITY, metric, 0)
        self.metrics.gauge(cm.SCOPE_TPU_VISIBILITY, cm.M_VIS_STALENESS,
                           0.0)
        # cluster telemetry plane (utils/timeseries, utils/hostprof,
        # utils/flightrecorder): constructed but NOT thread-started —
        # tests build boxes constantly and AdminHandler's timeseries/
        # hostprof verbs burst-sample on demand. Anchoring the sampler's
        # baseline here makes the first admin sample a window spanning
        # box-build → now. New-scope series pre-register so a scrape
        # distinguishes "telemetry idle" from "series missing".
        from ..utils.hostprof import HostProfiler
        from ..utils.timeseries import TimeSeriesSampler
        self.timeseries = TimeSeriesSampler(self.metrics)
        self.timeseries.sample_once()
        self.hostprof = HostProfiler(self.metrics)
        self.metrics.inc(cm.SCOPE_FLIGHTREC, "events", 0)
        self.metrics.inc(cm.SCOPE_FLIGHTREC, "dumps", 0)
        for gauge in ("samples", "gil-contention", "attributed-share",
                      "threads"):
            self.metrics.gauge(cm.SCOPE_HOSTPROF, gauge, 0.0)
        for gauge in ("windows", "samples", "utilization"):
            self.metrics.gauge(cm.SCOPE_TIMESERIES, gauge, 0.0)

    def enable_serving(self):
        """Wire the serving tier programmatically (tests / the loadgen
        comparison scenario flip it without env plumbing); idempotent.
        Covers engines already created and all future ones."""
        if self.serving is None:
            self.serving = self.tpu.serving_scheduler()
        for controller in self.controllers.values():
            for engine in controller._engines.values():
                engine.serving = self.serving
        return self.serving

    def _make_engine(self, shard) -> HistoryEngine:
        engine = HistoryEngine(shard, self.stores, self.clock)
        engine.device = self.device
        engine.replication_publisher_holder = self._publisher_holder
        engine.rebuilder = self.rebuilder
        engine.queries = self.query_registry
        engine.metrics = self.metrics
        engine.config = self.config
        engine.notifier = self.notifier
        # None until __init__ finishes (engines are created lazily, but
        # a custom engine_factory caller could race construction)
        engine.serving = getattr(self, "serving", None)
        return engine

    def set_replication_publisher(self, publisher) -> None:
        """Attach the cross-cluster stream (covers engines past and future)."""
        self._publisher_holder["pub"] = publisher

    # -- routing (client/history peer resolver analog) ---------------------

    def route(self, workflow_id: str) -> HistoryEngine:
        for controller in self.controllers.values():
            try:
                return controller.engine_for_workflow(workflow_id)
            except ShardNotOwnedError:
                continue
        raise ShardNotOwnedError(f"no host owns workflows like {workflow_id}")

    # -- cluster dynamics --------------------------------------------------

    def add_host(self, name: str) -> None:
        controller = ShardController(name, self.num_shards,
                                     self.stores, self.ring, self.clock,
                                     engine_factory=self._make_engine)
        self.controllers[name] = controller
        self.hosts.append(name)
        proc = QueueProcessors(controller, self.matching, self.stores,
                               self.clock, router=self.route,
                               metrics=self.metrics, config=self.config,
                               cluster_name=self.cluster_name)
        if self.processors:
            # inherit multi-cluster wiring done after construction
            proc.cross_cluster_publisher = \
                self.processors[0].cross_cluster_publisher
        self.processors.append(proc)
        self.ring.add_member(name)

    def remove_host(self, name: str) -> None:
        """Host death: ring change → survivors steal its shards (the ringpop
        failure-detection → acquireShards path). The dead controller is
        unsubscribed FIRST: a dead host does not react to ring changes, and
        leaving the listener would both leak it and gracefully release its
        shards, masking the fencing path this simulates."""
        controller = self.controllers.pop(name)
        self.hosts.remove(name)
        self.processors = [p for p in self.processors
                           if p.controller is not controller]
        self.ring.unsubscribe(controller._on_membership_change)
        self.ring.remove_member(name)

    # -- pumping -----------------------------------------------------------

    def pump_once(self) -> int:
        done = 0
        for p in self.processors:
            done += p.process_transfer_once()
            done += p.process_timers_once()
        return done

    def pump_until_quiet(self, max_rounds: int = 200) -> None:
        for _ in range(max_rounds):
            if self.pump_once() == 0 and self.matching.backlog() == 0:
                return
        raise RuntimeError("cluster did not quiesce")

    def advance_time(self, seconds: float) -> None:
        self.clock.advance(int(seconds * NANOS))

    # -- observability -----------------------------------------------------

    def scrape_server(self, address=("127.0.0.1", 0)):
        """An HTTP /metrics + /health + /traces surface over this box's
        registry (the same component rpc/server.ServiceHost mounts);
        caller starts/stops it."""
        from ..utils.scrape import ObservabilityHTTPServer

        def health():
            # liveness only — no O(executions) store walks in a probe a
            # poller may hit every few seconds (describe_cluster carries
            # the expensive rollups)
            return {"status": "ok", "cluster": self.cluster_name,
                    "hosts": list(self.hosts),
                    "matching_backlog": self.matching.backlog()}

        from ..utils import flightrecorder

        def timeseries_doc():
            self.timeseries.sample_once()
            return self.timeseries.doc()

        def flightrec_doc():
            recorder = flightrecorder.DEFAULT_RECORDER
            return {"stats": recorder.stats(),
                    "events": recorder.snapshot(200)}

        return ObservabilityHTTPServer(self.metrics, health_fn=health,
                                       tracer=self.tracer, address=address,
                                       timeseries_fn=timeseries_doc,
                                       hostprof_fn=self.hostprof.rollup,
                                       flightrec_fn=flightrec_doc)

    # -- recovery ----------------------------------------------------------

    def refresh_all_tasks(self) -> int:
        """Post-recovery sweep: regenerate outstanding tasks for every
        current run (the shard task queues and matching backlog are not
        durable — rebuilt state is). Returns tasks created."""
        from .task_refresher import sweep_refresh
        return sweep_refresh(self.stores, self.route)
