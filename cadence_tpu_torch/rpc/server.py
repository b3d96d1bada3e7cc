"""Service host: one history/matching/frontend process of a real cluster.

Reference: cmd/server/cadence/server.go:271-278 builds the four roles from
one binary; host/onebox.go runs them in-process for tests. This module is
the PROCESS-boundary deployment: each host runs

- a ShardController over the live-peer hashring (shards it owns get real
  engines; the rest raise ShardNotOwnedError and the router redirects),
- queue processors pumping its shards' transfer/timer queues,
- a matching engine for the task lists the ring assigns to it,
- a frontend serving any client (cross-host work forwards over the wire),

all against the store-server process (fenced writes evaluate THERE, so a
deposed owner's writes fail no matter what it believes about liveness —
the cross-host range-ID fence, shard/context.go:586-700).

Membership: each host heartbeats the store server and rebuilds its ring
from the live-peer set every tick; a host that stops beating (killed,
partitioned, paused) is dropped after the TTL and its shards are stolen.

Device: the host's device tier (the bulk verify engine, the serving
scheduler, shard migration, reset rebuilds) runs on the one device named
by `--device`; without it, the card. A host asked for the card on a box
without one exits at boot rather than serve from the CPU. With the
serving tier on the card, the kernel library loads before the host
answers its first ping.

Run: python -m cadence_tpu_torch.rpc.server --name host-0 --port P \
         --store HOST:PORT [--num-shards 8] [--hb-interval 0.2] [--ttl 1.0] \
         [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import socketserver
import threading
import time
from contextlib import nullcontext
from typing import Dict, Optional, Tuple

from ..engine.controller import ShardController, ShardNotOwnedError
from ..engine.crosscluster import CrossClusterProcessor
from ..engine.frontend import Frontend
from ..engine.history_engine import HistoryEngine
from ..engine.matching import MatchingEngine
from ..engine.membership import HashRing
from ..engine.queues import QueueProcessors
from ..loadgen.slo import BurnRateEvaluator, BurnTarget
from ..utils import deadline as deadline_mod
from ..utils import flightrecorder
from ..utils import hostprof as hostprof_mod
from ..utils import timeseries as timeseries_mod
from ..utils import tracing
from ..utils.circuitbreaker import (
    BreakerRegistry,
    CircuitOpenError,
    ServiceBusy,
)
from ..utils.clock import RealTimeSource
from ..utils.deadline import DeadlineExceeded
from . import chaos as chaos_mod
from .client import RemoteEngine, RemoteMatching, RemoteStores
from .wire import recv_frame, send_frame, verify_hello

#: server-side p99 latency ceiling (ms) the burn-rate evaluator watches
#: over the frontend start/signal histograms
ENV_SLO_P99_MS = "CADENCE_TPU_SLO_P99_MS"

#: the metrics scope of a host's kernel launches, one gauge a kernel
SCOPE_LAUNCHES = "tpu.launches"


def _slo_p99_s() -> float:
    try:
        return max(0.001,
                   float(os.environ.get(ENV_SLO_P99_MS, "500")) / 1000.0)
    except ValueError:
        return 0.5


class RoutedMatching:
    """Task-list-ownership router: calls for lists the ring assigns to
    this host run on the local MatchingEngine; the rest forward to the
    owner (client/matching routing by task list)."""

    #: method name → index of the task-list argument in *args
    _TL_ARG = {
        "add_decision_task": 1, "add_activity_task": 1, "add_query_task": 1,
        "poll_and_wait_decision": 1, "poll_and_wait_activity": 1,
        "poll_for_decision_task": 1, "poll_for_activity_task": 1,
        "describe_task_list": 1,
    }

    def __init__(self, host: "ServiceHost") -> None:
        self._host = host
        self.local = MatchingEngine(host.stores, config=host.config)

    def _forward(self, task_list: str) -> Optional[RemoteMatching]:
        owner, address = self._host.tasklist_owner(task_list)
        if owner == self._host.name:
            return None
        return RemoteMatching(address, metrics=self._host.metrics,
                              breakers=self._host.breakers,
                              retry_policy=self._host.retry_policy)

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        local = self.local
        impl = getattr(local, method)
        tl_index = self._TL_ARG.get(method)

        if tl_index is None and method in ("requeue_task", "complete_task"):
            def invoke(task, task_type):
                target = self._forward(task.task_list)
                fn = getattr(target, method) if target else getattr(local, method)
                return fn(task, task_type)
            return invoke
        if tl_index is None:
            return impl

        def invoke(*args, **kwargs):
            target = self._forward(args[tl_index])
            return (getattr(target, method) if target else impl)(*args, **kwargs)

        return invoke


class _XdcConsumer:
    """One peer cluster's inbound machinery: history replication, domain
    metadata, and the two cross-cluster task directions."""

    def __init__(self, name, cluster, repl, domain, xc) -> None:
        self.name = name
        self.cluster = cluster
        self.repl = repl
        self.domain = domain
        self.xc = xc


class _WireCrossClusterProcessor(CrossClusterProcessor):
    """CrossClusterProcessor whose RESULT leg routes by the source
    domain's CURRENT active cluster (looked up in the local, replicated
    domain table): locally-active sources apply through the ring;
    remotely-active ones go back through the peer's engine_routed door.
    The reference's cross_cluster_task_processor responds through the
    source cluster's history client the same way."""

    def __init__(self, source_stores, target_router, local_cluster,
                 target_stores, host: "ServiceHost") -> None:
        super().__init__(source_stores, target_router, None, local_cluster,
                         target_stores=target_stores)
        self._host = host

    def _source_engine(self, task):
        host = self._host
        active = None
        try:
            active = host.stores.domain.by_id(
                task.source_domain_id).active_cluster
        except Exception:
            pass
        if active is None or active == host.cluster_name:
            return host.route(task.source_workflow_id)
        consumer = next((c for c in host._xdc_consumers
                         if c.name == active), None)
        if consumer is None:  # unknown cluster: try any peer
            consumer = host._xdc_consumers[0]
        return consumer.cluster.engine(task.source_workflow_id)


class ServiceHost(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, name: str, address: Tuple[str, int],
                 store_address: Tuple[str, int], num_shards: int,
                 hb_interval: float = 0.15, ttl: float = 3.0,
                 pump_interval: float = 0.05,
                 cluster_name: str = "primary",
                 peers: Optional[Dict[str, Tuple[str, int]]] = None,
                 advertise_host: str = "127.0.0.1",
                 http_port: int = 0, device=None) -> None:
        super().__init__(address, _Handler)
        from ..device import resolve_device
        from ..utils.dynamicconfig import DynamicConfig
        from ..utils.metrics import MetricsRegistry

        #: the one device this host's device tier runs on (None: the card,
        #: and without one the host refuses to boot)
        self.device = resolve_device(device)
        self.name = name
        self.port = address[1]
        #: the address peers must DIAL to reach this host (loopback only
        #: works single-machine; containers advertise their service name)
        self.advertise_host = advertise_host
        self.num_shards = num_shards
        self.hb_interval = hb_interval
        self.ttl = ttl
        self.cluster_name = cluster_name
        #: peer cluster name → its STORE server address (the cluster-group
        #: config, development_xdc_cluster0.yaml:71-94 analog)
        self.peers = dict(peers or {})
        self.clock = RealTimeSource()
        self.config = DynamicConfig()
        self.metrics = MetricsRegistry()
        #: per-target circuit breakers shared by EVERY outbound client this
        #: host creates (store, peer engines, matching forwards) — breaker
        #: state gauges land on this host's /metrics
        from ..utils import dynamicconfig as dc
        from .client import retry_policy_from_config
        self.breakers = BreakerRegistry(
            metrics=self.metrics,
            failure_threshold=int(
                self.config.get(dc.KEY_RPC_BREAKER_FAILURE_THRESHOLD)),
            reset_timeout_s=float(
                self.config.get(dc.KEY_RPC_BREAKER_RESET_TIMEOUT_S)))
        self.retry_policy = retry_policy_from_config(self.config)
        self.stores = RemoteStores(store_address, metrics=self.metrics,
                                   breakers=self.breakers,
                                   retry_policy=self.retry_policy)
        # pre-register the resilience counters so /metrics always exposes
        # the names (scraped as zero before the first retry/shed/expiry)
        for scope_name, metric in (("rpc.client", "retries"),
                                   ("rpc.client", "breaker-rejected"),
                                   ("rpc.client", "deadline-expired"),
                                   ("rpc.server",
                                    "deadline-expired-rejections"),
                                   ("rpc.circuitbreaker", "transitions")):
            self.metrics.inc(scope_name, metric, 0)
        # resident-state cache series likewise pre-registered: scrapes
        # show tpu.resident/* as zero before the first verify touches it
        from ..utils import metrics as cm
        for metric in (cm.M_CACHE_HITS, cm.M_RESIDENT_SUFFIX_HITS,
                       cm.M_CACHE_MISSES, cm.M_CACHE_EVICTIONS,
                       cm.M_CACHE_INVALIDATIONS,
                       cm.M_RESIDENT_EVENTS_APPENDED,
                       cm.M_RESIDENT_WIDENED, cm.M_RESIDENT_NARROWED):
            self.metrics.inc(cm.SCOPE_TPU_RESIDENT, metric, 0)
        for gauge in (cm.M_RESIDENT_BYTES, cm.M_RESIDENT_ENTRIES,
                      cm.M_RESIDENT_BUDGET_BYTES):
            self.metrics.gauge(cm.SCOPE_TPU_RESIDENT, gauge, 0.0)
        # native-encoder series: the availability gauge answers "does
        # THIS process have the compiled fast path" on every scrape.
        # Boot publishes from the build-cache PROBE (file-hash check,
        # never a compiler run — a fresh box must not block startup on
        # g++); the first wirec pack through this registry re-publishes
        # the live value. Pack counters start visible at zero.
        from ..native import build as native_build
        self.metrics.gauge(cm.SCOPE_TPU_NATIVE, cm.M_NATIVE_AVAILABLE,
                           1.0 if native_build.wirec_cached() else 0.0)
        self.metrics.inc(cm.SCOPE_TPU_NATIVE, cm.M_NATIVE_PACKS, 0)
        self.metrics.inc(cm.SCOPE_TPU_NATIVE, cm.M_NATIVE_PY_PACKS, 0)
        # mesh-aware executor series likewise pre-registered, with the
        # per-device labels the CADENCE_TPU_MESH_DEVICES knob implies
        # (the knob is parsed WITHOUT touching the card; "all"
        # resolves at first dispatch, so only dev0 pre-registers then)
        from ..parallel.mesh import mesh_devices_requested
        n_mesh = mesh_devices_requested() or 1
        self.metrics.inc(cm.SCOPE_TPU_EXECUTOR, cm.M_EXEC_CHUNKS, 0)
        self.metrics.gauge(cm.SCOPE_TPU_EXECUTOR, cm.M_EXEC_DEVICE_BUSY,
                           0.0)
        for d in range(n_mesh):
            self.metrics.inc(
                cm.SCOPE_TPU_EXECUTOR,
                cm.device_metric(cm.M_EXEC_CHUNKS, d), 0)
            self.metrics.inc(
                cm.SCOPE_TPU_EXECUTOR,
                cm.device_metric(cm.M_EXEC_ROWS, d), 0)
            self.metrics.gauge(
                cm.SCOPE_TPU_EXECUTOR,
                cm.device_metric(cm.M_EXEC_DEVICE_BUSY, d), 0.0)
        # per-host quota knobs (common/quotas seat): the env var is the
        # subprocess-cluster path (rpc/cluster.launch env_per_role hands
        # each host its own spec — a cluster-wide RPS budget is split
        # across hosts because each host's buckets are local); values
        # land in dynamicconfig, so the frontend's live closures pick
        # them up and later operator config.set updates still win
        from ..utils import quotas as quotas_mod
        quota_spec = os.environ.get(quotas_mod.QUOTAS_ENV, "")
        if quota_spec:
            g_rps, g_burst, domain_rps = quotas_mod.parse_quota_spec(
                quota_spec)
            if g_rps:
                self.config.set(dc.KEY_FRONTEND_RPS, g_rps)
            if g_burst:
                self.config.set(dc.KEY_FRONTEND_BURST, g_burst)
            for domain, rps in domain_rps.items():
                self.config.set(dc.KEY_FRONTEND_DOMAIN_RPS, rps,
                                domain=domain)
        # admission-control series pre-registered: a scrape shows
        # quotas/admitted + quotas/shed as zero before the first request
        # (per-domain series appear as domains take traffic)
        self.metrics.inc(cm.SCOPE_QUOTAS, cm.M_QUOTA_ADMITTED, 0)
        self.metrics.inc(cm.SCOPE_QUOTAS, cm.M_QUOTA_SHED, 0)
        # membership/controller/partition witnesses pre-registered: a
        # chaos campaign must distinguish "no flap observed" and "no
        # partition enforced" from "series missing" on every host
        self.metrics.inc(cm.SCOPE_MEMBERSHIP, cm.M_RING_DROPS, 0)
        self.metrics.inc(cm.SCOPE_MEMBERSHIP, cm.M_RING_JOINS, 0)
        self.metrics.gauge(cm.SCOPE_MEMBERSHIP, cm.M_RING_GENERATION, 0.0)
        self.metrics.inc(cm.SCOPE_CONTROLLER, cm.M_FENCED_EVICTIONS, 0)
        self.metrics.inc(chaos_mod.SCOPE_PARTITION,
                         chaos_mod.M_PART_BLOCKED_SENDS, 0)
        self.metrics.gauge(chaos_mod.SCOPE_PARTITION,
                           chaos_mod.M_PART_ACTIVE, 0.0)
        # the process partition table reports into THIS host's registry
        # (scrapes and admin_metrics see what this host enforces)
        chaos_mod.partitions().registry = self.metrics
        # device-serving tier series pre-registered (tpu.serving/*): the
        # parity-divergence counter in particular must ALWAYS scrape — a
        # missing series and "zero divergences" must be distinguishable
        for metric in (cm.M_SERVING_TXNS, cm.M_SERVING_LAUNCHES,
                       cm.M_SERVING_COALESCED, cm.M_SERVING_DIVERGENCE,
                       cm.M_SERVING_EXACT, cm.M_SERVING_SUFFIX,
                       cm.M_SERVING_COLD, cm.M_SERVING_BYPASSED,
                       cm.M_SERVING_REQUEUED, cm.M_SERVING_REJECTED):
            self.metrics.inc(cm.SCOPE_TPU_SERVING, metric, 0)
        self.metrics.gauge(cm.SCOPE_TPU_SERVING, cm.M_SERVING_QUEUE_DEPTH,
                           0.0)
        # snapshot-tier series pre-registered (tpu.snapshot/*): a scrape
        # must distinguish "no torn snapshots" from "series missing",
        # same contract as the serving divergence counter
        for metric in (cm.M_SNAP_WRITES, cm.M_SNAP_CHECKSUM_SKIPS,
                       cm.M_SNAP_HYDRATES, cm.M_SNAP_IGNORED_STALE,
                       cm.M_SNAP_IGNORED_TORN):
            self.metrics.inc(cm.SCOPE_TPU_SNAPSHOT, metric, 0)
        for gauge in (cm.M_SNAP_ENTRIES, cm.M_SNAP_BYTES):
            self.metrics.gauge(cm.SCOPE_TPU_SNAPSHOT, gauge, 0.0)
        # the tier itself (engine/serving.py): CADENCE_TPU_SERVING=1
        # builds this host's TPUReplayEngine over the REMOTE stores and
        # hands every engine a shared scheduler — committed transactions
        # micro-batch into from-state launches; default off (the tier is
        # a deployment choice, and verify/rebuild work without it)
        from ..engine import serving as serving_mod
        self.serving = None
        self.tpu = None
        self.migration = None
        if serving_mod.enabled():
            from ..engine.tpu_engine import TPUReplayEngine
            if self.device.type == "cuda":
                # the kernel library loads now, before the first ping is
                # answered, so no request ever waits on it
                from ..ops import _build
                _build.load()
            tpu = TPUReplayEngine(self.stores, self.config.payload_layout(),
                                  device=self.device)
            tpu.metrics = self.metrics
            self.tpu = tpu
            self.serving = tpu.serving_scheduler()
            # live HBM state migration (engine/migration.py): shard
            # movement snapshots this host's resident rows out and
            # hydrates acquired shards from the SHARED snapshot store
            # (which lives in the store-server process — records written
            # by any host are immediately visible to every peer); wired
            # to the controller's membership hooks below
            from ..engine.migration import MigrationManager
            self.migration = MigrationManager(name, num_shards, tpu,
                                              registry=self.metrics)
            for metric in (cm.M_MIG_OUT, cm.M_MIG_OUT_SKIPPED,
                           cm.M_MIG_EVICTED, cm.M_MIG_IN, cm.M_MIG_COLD,
                           cm.M_MIG_YOUNG, cm.M_MIG_STALE,
                           cm.M_MIG_SUFFIX_EVENTS,
                           cm.M_MIG_DIVERGENCE, cm.M_MIG_UNSTABLE):
                self.metrics.inc(cm.SCOPE_TPU_MIGRATION, metric, 0)
        # boot warm-up: the first live drain window must never pay the
        # first launches' allocator growth (a stalled drain lets folds
        # outgrow the warmed buckets; the failure serving_scenario's
        # in-process warm() exists for) — background thread so the host
        # serves immediately, flushes that race the warm just pay what
        # they would have anyway; `serving_warmed` is surfaced in the
        # admin_cluster doc so deploys/scenarios can hold traffic until
        # the fleet is hot
        self.serving_warmed = self.serving is None
        if self.serving is not None and serving_mod.warm_on_boot():
            def _warm_serving():
                try:
                    self.serving.warm(
                        e_shapes=serving_mod.warm_event_shapes())
                except Exception:
                    # the host still serves (its flushes pay what the
                    # warm-up would have), but its log says why
                    import traceback
                    traceback.print_exc()
                self.serving_warmed = True
            threading.Thread(target=_warm_serving, daemon=True,
                             name="cadence-serving-warm").start()
        elif self.serving is not None:
            self.serving_warmed = True
        # wire chaos can also arrive via dynamicconfig (the env var is the
        # subprocess path; an operator override here wins)
        chaos_spec = self.config.get(dc.KEY_WIRE_CHAOS)
        if chaos_spec:
            chaos_mod.install(chaos_mod.parse_spec(chaos_spec))
        # durability crashpoints ride the same contract (env var for
        # subprocesses, dynamicconfig for operator overrides)
        crash_spec = self.config.get(dc.KEY_CRASHPOINT)
        if crash_spec:
            from ..engine import crashpoints
            crashpoints.install(crashpoints.parse_spec(crash_spec))
        # -- cluster telemetry plane ----------------------------------------
        # the process-global flight recorder counts onto THIS host's
        # registry (one host per process in production; in-process test
        # hosts share the ring, which is exactly the interleaved timeline
        # a post-mortem wants); sampler + profiler objects always exist
        # (the admin ops and scrape endpoints need them) but their
        # threads only start in start(), each gated on its env knob
        flightrecorder.DEFAULT_RECORDER.metrics = self.metrics
        self.metrics.inc(cm.SCOPE_FLIGHTREC, "events", 0)
        self.metrics.inc(cm.SCOPE_FLIGHTREC, "dumps", 0)
        self.timeseries = timeseries_mod.TimeSeriesSampler(self.metrics)
        if self.serving is not None:
            serving_ref = self.serving
            self.timeseries.set_capacity(
                cm.SCOPE_TPU_SERVING, cm.M_SERVING_QUEUE_DEPTH,
                lambda: serving_ref.max_queue)
        self.hostprof = hostprof_mod.HostProfiler(self.metrics)
        for gauge in ("samples", "gil-contention", "attributed-share",
                      "threads"):
            self.metrics.gauge(cm.SCOPE_HOSTPROF, gauge, 0.0)
        for gauge in ("windows", "samples", "utilization"):
            self.metrics.gauge(cm.SCOPE_TIMESERIES, gauge, 0.0)
        # server-side SLO: frontend start/signal latency p99 under the
        # CADENCE_TPU_SLO_P99_MS ceiling; evaluated on every sampler tick
        # so the burn gauges land inside the NEXT /timeseries window and
        # `admin top` reads them fleet-wide with no extra endpoint
        slo_s = _slo_p99_s()
        self.burn = BurnRateEvaluator(
            self.timeseries,
            [BurnTarget("frontend-start", cm.SCOPE_FRONTEND_START,
                        cm.M_LATENCY, slo_s),
             BurnTarget("frontend-signal", cm.SCOPE_FRONTEND_SIGNAL,
                        cm.M_LATENCY, slo_s)],
            registry=self.metrics)
        self.timeseries.on_sample = lambda window: self.burn.evaluate()
        self.tracer = tracing.DEFAULT_TRACER
        #: HTTP scrape surface (/metrics, /health, /traces, /timeseries,
        #: /hostprof, /flightrec): bound in __init__ so the port is known
        #: before start(); 0 = ephemeral
        from ..utils.scrape import ObservabilityHTTPServer
        self.scrape = ObservabilityHTTPServer(
            self.metrics, health_fn=self._health, tracer=self.tracer,
            address=(address[0], http_port),
            timeseries_fn=self.timeseries_doc,
            hostprof_fn=self.hostprof_doc,
            flightrec_fn=self.flightrec_doc)
        #: shared across every engine this host creates (multi-cluster
        #: replication publish seam)
        self._publisher_holder: Dict[str, object] = {"pub": None}
        #: name → (host, port) of every live peer (incl. self)
        self._peer_addresses: Dict[str, Tuple[str, int]] = {
            name: (advertise_host, address[1])}
        self.ring = HashRing([name])
        self.controller = ShardController(name, num_shards, self.stores,
                                          self.ring, self.clock,
                                          engine_factory=self._make_engine)
        self.controller.metrics = self.metrics
        if self.migration is not None:
            self.controller.on_shards_released = \
                self.migration.shards_released
            self.controller.on_shards_acquired = \
                self.migration.shards_acquired
        self.matching = RoutedMatching(self)
        self.frontend = Frontend(self.stores, self.matching, self.route,
                                 config=self.config, metrics=self.metrics,
                                 time_source=self.clock,
                                 cluster_name=cluster_name)
        self.processors = QueueProcessors(self.controller, self.matching,
                                          self.stores, self.clock,
                                          router=self.route,
                                          metrics=self.metrics,
                                          config=self.config,
                                          cluster_name=cluster_name)
        self._xdc_consumers = []
        if self.peers:
            self._wire_cluster_group()
        # the production pump is the N-worker pool (per-domain fairness,
        # redispatch, contiguous acks — engine/tasks.py); store round-trips
        # are I/O the workers overlap
        from ..engine.tasks import TaskScheduler
        self.scheduler = TaskScheduler(num_workers=4)
        self._stop = threading.Event()
        self._beat_thread = threading.Thread(target=self._beat_loop,
                                             daemon=True,
                                             name="cadence-membership-beat")
        self._pump_interval = pump_interval
        self._pump_thread = threading.Thread(target=self._pump_loop,
                                             daemon=True,
                                             name="cadence-queue-pump")

    # -- engines -----------------------------------------------------------

    def _make_engine(self, shard) -> HistoryEngine:
        engine = HistoryEngine(shard, self.stores, self.clock)
        engine.metrics = self.metrics
        engine.config = self.config
        engine.replication_publisher_holder = self._publisher_holder
        engine.serving = self.serving
        engine.device = self.device
        return engine

    # -- cluster group (XDC over the wire) ---------------------------------

    def _wire_cluster_group(self) -> None:
        """Compose this host into its cluster group: outbound — engines
        publish committed batches and domain mutations onto the LOCAL
        store's replication queues; inbound — per-peer consumers poll the
        PEER'S store server over sockets and apply here (the remote-poller
        shape of replication/task_fetcher.go + worker/replicator). Ack
        levels persist in the local store, so the pumps survive host death
        and leadership moves (persistence/queue.go UpdateAckLevel)."""
        from ..engine.crosscluster import CrossClusterPublisher
        from ..engine.domainrepl import (
            DomainReplicationProcessor,
            DomainReplicationPublisher,
        )
        from ..engine.replication import (
            HistoryReplicator,
            ReplicationPublisher,
            ReplicationTaskProcessor,
        )
        from .client import RemoteCluster

        pub = ReplicationPublisher(self.stores)
        self._publisher_holder["pub"] = pub
        self.frontend.domain_replication_publisher = (
            DomainReplicationPublisher(self.stores))
        self.processors.cross_cluster_publisher = (
            CrossClusterPublisher(self.stores))
        # snapshot-shipping replication: every record this host's
        # post-append policy writes also rides the outbound replication
        # stream, so standby regions keep warm hydration sources without
        # ever replaying full histories
        if self.tpu is not None:
            cluster = self.cluster_name
            self.tpu.snapshotter().shipper = (
                lambda rec: pub.publish_snapshot(rec, cluster))
        # replication series pre-registered (replication.task-processor/*):
        # the device-parity divergence counter and the DLQ depth gauge in
        # particular must ALWAYS scrape — "zero divergence" and "series
        # missing" must be distinguishable (same contract as tpu.serving)
        from ..utils import metrics as cm
        for metric in (cm.M_REPL_APPLIED, cm.M_REPL_DEDUPED,
                       cm.M_REPL_RESENT, cm.M_REPL_DLQ, cm.M_REPL_REDRIVEN,
                       cm.M_REPL_DEVICE_APPLIED,
                       cm.M_REPL_DEVICE_SUFFIX_EVENTS,
                       cm.M_REPL_DEVICE_COLD, cm.M_REPL_DEVICE_STALE,
                       cm.M_REPL_DEVICE_DIVERGENCE,
                       cm.M_REPL_DEVICE_UNSTABLE,
                       cm.M_REPL_SNAP_SHIPPED, cm.M_REPL_SNAP_INSTALLED,
                       cm.M_REPL_SNAP_IGNORED_TORN,
                       cm.M_REPL_SNAP_IGNORED_STALE,
                       cm.M_REPL_SNAP_IGNORED_FOREIGN,
                       cm.M_REPL_BP_SHED, cm.M_REPL_BP_DEFERRED,
                       cm.M_DOMREPL_APPLIED, cm.M_DOMREPL_STALE_REJECTED,
                       cm.M_DOMREPL_DUPLICATE):
            self.metrics.inc(cm.SCOPE_REPLICATION, metric, 0)
        self.metrics.gauge(cm.SCOPE_REPLICATION, cm.M_REPL_DLQ_DEPTH, 0.0)

        for peer_name, store_addr in self.peers.items():
            peer = RemoteCluster(store_addr, peer_ttl=self.ttl,
                                 metrics=self.metrics,
                                 breakers=self.breakers,
                                 retry_policy=self.retry_policy)

            def read_peer_history(domain_id, workflow_id, run_id,
                                  from_id, to_id, _peer=peer):
                batches = _peer.stores.history.as_history_batches(
                    domain_id, workflow_id, run_id)
                return [b for b in batches
                        if from_id <= b.events[0].id < to_id]

            repl = ReplicationTaskProcessor(
                HistoryReplicator(self.stores),
                ReplicationPublisher(peer.stores), self.stores,
                source_history_reader=read_peer_history,
                tpu=self.tpu)
            repl.metrics = self.metrics
            domain = DomainReplicationProcessor(peer.stores, self.stores,
                                                self.cluster_name)
            domain.metrics = self.metrics
            domain.on_applied = self._on_domain_replicated
            xc_peer = _WireCrossClusterProcessor(
                peer.stores, self.route, self.cluster_name,
                target_stores=self.stores, host=self)
            xc_self = _WireCrossClusterProcessor(
                self.stores, self.route, self.cluster_name,
                target_stores=self.stores, host=self)
            self._xdc_consumers.append(
                _XdcConsumer(peer_name, peer, repl, domain,
                             (xc_peer, xc_self)))

    def _on_domain_replicated(self, task, became_active: bool) -> None:
        """Standby promotion: a replicated flip that makes a domain active
        HERE regenerates its outstanding tasks from mutable state (the
        failover_watcher → RefreshTasks path; without it, pre-failover
        pending work never runs on the new active side)."""
        if not became_active:
            return
        try:
            from ..engine.task_refresher import sweep_refresh
            sweep_refresh(self.stores, self.route, task.domain_id)
        except Exception:
            from ..utils.log import DEFAULT_LOGGER
            DEFAULT_LOGGER.error("promotion task refresh failed",
                                 component="xdc", domain=task.name)
        # warm promotion: hydrate THIS host's shards from shipped
        # snapshots so the first post-flip transactions land on resident
        # rows (peers hydrate via the admin_prehydrate wire op — only
        # the leader sees the replicated flip)
        if self.migration is not None:
            try:
                self.migration.hydrate_shards(self.controller.owned_shards())
            except Exception:
                from ..utils.log import DEFAULT_LOGGER
                DEFAULT_LOGGER.error("promotion hydration failed",
                                     component="xdc", domain=task.name)

    def _pump_xdc(self) -> None:
        """One inbound-replication tick. Leader-gated: the host owning
        shard 0 runs the cluster's consumers (leadership follows the ring;
        persisted acks make handoff seamless). Ack levels load before and
        persist after each pass, monotonic under leadership flaps."""
        if 0 not in self.controller.owned_shards():
            return
        me = self.cluster_name
        for c in self._xdc_consumers:
            q = self.stores.queue
            try:
                ack_key = f"repl-from:{c.name}"
                c.repl.ack_index = max(c.repl.ack_index,
                                       q.get_ack(ack_key, me))
                if c.repl.process_once():
                    q.set_ack(ack_key, me, c.repl.ack_index - 1)
            except Exception:
                pass  # peer briefly unreachable; next tick retries
            try:
                dkey = f"domainrepl-from:{c.name}"
                c.domain._cursor = max(c.domain._cursor,
                                       q.get_ack(dkey, me))
                c.domain.process_once()
                if c.domain._cursor > 0:
                    q.set_ack(dkey, me, c.domain._cursor - 1)
            except Exception:
                pass
            for tag, xc in (("peer", c.xc[0]), ("self", c.xc[1])):
                try:
                    xkey = f"xc-from:{c.name}:{tag}"
                    xc._cursor = max(xc._cursor, q.get_ack(xkey, me))
                    xc.process_once()
                    if xc._cursor > 0:
                        q.set_ack(xkey, me, xc._cursor - 1)
                except Exception:
                    pass

    def route(self, workflow_id: str):
        """History router: local engine when this host owns the shard,
        RemoteEngine to the owner otherwise (SURVEY §3.1 process boundary)."""
        try:
            return self.controller.engine_for_workflow(workflow_id)
        except ShardNotOwnedError:
            owner = self.ring.lookup(
                f"shard-{self.controller.shard_for(workflow_id)}")
            address = self._peer_addresses.get(owner)
            if address is None:
                raise
            return RemoteEngine(address, workflow_id, metrics=self.metrics,
                                breakers=self.breakers,
                                retry_policy=self.retry_policy)

    def tasklist_owner(self, task_list: str) -> Tuple[str, Tuple[str, int]]:
        owner = self.ring.lookup(f"tasklist-{task_list}")
        return owner, self._peer_addresses.get(
            owner, (self.advertise_host, self.port))

    # -- cluster rollup (the admin_cluster wire op body) --------------------

    def cluster_doc(self, detail: bool = False) -> Dict[str, object]:
        """Per-host shard ownership + device-tier occupancy: what the
        `admin cluster` CLI verb and the multi-host scenarios roll up
        across every live host. `detail` adds each resident row's
        canonical payload CRC32 + branch + content address — the
        byte-parity surface the planned-rebalance gate compares against
        the oracle after a migration."""
        doc: Dict[str, object] = {
            "name": self.name,
            "cluster": self.cluster_name,
            "num_shards": self.num_shards,
            "owned_shards": sorted(self.controller.owned_shards()),
            "assigned_shards": sorted(self.controller.assigned_shards()),
            "ring": sorted(self.ring.members()),
            "serving": (self.serving.stats()
                        if self.serving is not None else None),
            "serving_warmed": bool(self.serving_warmed),
            "resident": (self.tpu.resident.stats()
                         if self.tpu is not None else None),
            "migration": (self.migration.stats()
                          if self.migration is not None else None),
            "device": str(self.device),
            "launch_shapes": self.launch_shapes(),
        }
        if detail and self.tpu is not None:
            from ..engine.migration import resident_row_checksums
            doc["resident_rows"] = resident_row_checksums(
                self.tpu.resident)
        return doc

    def publish_launches(self) -> None:
        """This process's kernel launches (ops/_build.launches, counted
        where each wrapper launches; one host a process) as gauges of the
        `tpu.launches` scope, so every admin_metrics snapshot carries
        them."""
        from ..ops import _build

        for name, count in _build.launches.items():
            self.metrics.gauge(SCOPE_LAUNCHES, name, float(count))

    def launch_shapes(self):
        """[(kernel, shape of its first tensor argument, launches)] of
        this process, sorted."""
        from ..ops import _build

        return sorted((name, tuple(int(d) for d in shape), int(n))
                      for (name, shape), n in _build.launch_shapes.items())

    # -- telemetry docs (scrape endpoints + the admin_* wire ops) ----------

    def timeseries_doc(self, last_n: Optional[int] = 120) -> Dict[str, object]:
        """The GET /timeseries body: the ring windows plus the current
        burn-rate verdict (evaluated fresh, unpublished — the published
        gauges already ride the windows with one-tick lag)."""
        doc = self.timeseries.doc(last_n)
        doc["host"] = self.name
        doc["slo"] = self.burn.evaluate(publish=False)
        return doc

    def hostprof_doc(self, duration_s: float = 0.0) -> Dict[str, object]:
        """The GET /hostprof body. With the profiler thread running the
        rollup is free; a host running with CADENCE_TPU_HOSTPROF=0 can
        still be burst-profiled by passing duration_s (the wire op's
        knob)."""
        prof = self.hostprof
        if duration_s > 0 and (prof._thread is None
                               or not prof._thread.is_alive()):
            deadline = time.monotonic() + duration_s
            while True:
                prof.sample_once()
                if time.monotonic() >= deadline:
                    break
                time.sleep(prof.period_s)
        doc = prof.rollup()
        doc["host"] = self.name
        return doc

    def flightrec_doc(self, last_n: int = 200) -> Dict[str, object]:
        recorder = flightrecorder.DEFAULT_RECORDER
        return {"host": self.name, "stats": recorder.stats(),
                "events": recorder.snapshot(last_n)}

    # -- health (the /health probe body) -----------------------------------

    def _health(self) -> Dict[str, object]:
        return {"status": "ok", "name": self.name,
                "cluster": self.cluster_name,
                "owned_shards": sorted(self.controller.owned_shards()),
                "ring": sorted(self.ring.members())}

    # -- membership --------------------------------------------------------

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.hb_interval):
            try:
                self.refresh_membership()
            except Exception:
                continue  # store server briefly unreachable: keep beating

    def refresh_membership(self) -> None:
        self.stores.heartbeat(self.name, self.port, self.advertise_host)
        peers = self.stores.peers(self.ttl)
        names = {entry[0] for entry in peers}
        # peers carry their ADVERTISED host in the heartbeat table (old
        # 2-tuple servers imply loopback)
        self._peer_addresses = {
            entry[0]: ((entry[2], entry[1]) if len(entry) > 2
                       else ("127.0.0.1", entry[1]))
            for entry in peers}
        self._peer_addresses.setdefault(
            self.name, (self.advertise_host, self.port))
        current = set(self.ring.members())
        if names and names != current:
            # ring changes fire the controller's acquire/release callback
            # (shard/controller.go:381) — the steal path
            joined, dropped = names - current, current - names
            for m in joined:
                self.ring.add_member(m)
            for m in dropped:
                self.ring.remove_member(m)
            # flap witnesses: per-host drop/join counters plus a monotonic
            # ring generation, so a chaos campaign can assert "the fleet
            # OBSERVED the flap" from /metrics instead of inferring it
            # from traffic (gen/cluster_chaos.py membership-flap gate)
            from ..utils import metrics as cm
            self.metrics.inc(cm.SCOPE_MEMBERSHIP, cm.M_RING_JOINS,
                             len(joined))
            self.metrics.inc(cm.SCOPE_MEMBERSHIP, cm.M_RING_DROPS,
                             len(dropped))
            self.metrics.gauge(cm.SCOPE_MEMBERSHIP, cm.M_RING_GENERATION,
                               self.ring.generation)
            flightrecorder.emit("ring-change", host=self.name,
                                joined=sorted(joined),
                                dropped=sorted(dropped),
                                members=sorted(names))
        # idempotent re-acquisition: a transient store error during an
        # earlier eager acquire must not leave assigned shards engineless
        self.controller.ensure_assigned()

    def _pump_loop(self) -> None:
        while not self._stop.wait(self._pump_interval):
            try:
                self.processors.process_transfer_concurrent(self.scheduler)
                self.processors.process_timers_once()
            except Exception:
                continue  # shard moved mid-pump etc.; next tick retries
            if self._xdc_consumers:
                self._pump_xdc()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        # arm the black box FIRST: a host that dies during boot should
        # still leave its record behind
        flightrecorder.install_dump_handlers()
        flightrecorder.emit("host-boot", host=self.name,
                            cluster=self.cluster_name, port=self.port,
                            shards=self.num_shards)
        self.refresh_membership()
        self._beat_thread.start()
        self._pump_thread.start()
        self.scrape.start()
        if timeseries_mod.enabled():
            self.timeseries.start()
        if hostprof_mod.enabled():
            self.hostprof.start()
        threading.Thread(target=self.serve_forever, daemon=True,
                         name="cadence-rpc-accept").start()

    def stop(self) -> None:
        flightrecorder.emit("host-stop", host=self.name)
        self._stop.set()
        for telemetry in (self.timeseries, self.hostprof):
            try:
                telemetry.stop()
            except Exception:
                pass
        if self.serving is not None:
            try:
                self.serving.stop()
            except Exception:
                pass
        try:
            self.scrape.stop()
        except Exception:
            pass
        self.shutdown()


#: matching poll ops that hand out a matched task in their response — the
#: task type routes the dead-socket requeue
_MATCHING_POLLS = {
    "poll_and_wait_decision": 0, "poll_for_decision_task": 0,
    "poll_and_wait_activity": 1, "poll_for_activity_task": 1,
}


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        """One connection, many frames. Op execution and transport are kept
        strictly apart: an op that raises ConnectionError (e.g. an outbound
        hop to a DEAD PEER was refused) is an op ERROR to report to the
        caller — only failures on THIS socket end the connection."""
        server: ServiceHost = self.server  # type: ignore[assignment]
        # name the per-connection thread so hostprof attributes RPC
        # service time to rpc-dispatch rather than "other"
        threading.current_thread().name = "cadence-rpc-dispatch"
        try:
            verify_hello(self.request)  # before the first pickle load
        except (OSError, ConnectionError):
            return
        while True:
            try:
                req = recv_frame(self.request)
            except (OSError, ConnectionError):
                return
            # a traced envelope parents this request's span on the caller's
            # span; untraced traffic (pump loops, heartbeats) stays span-free;
            # the caller's DEADLINE budget rides the same carrier
            remote_deadline = deadline_mod.peek(req)
            remote_ctx, req = tracing.extract(req)
            matched_poll = None  # (task, task_type) needing dead-socket requeue
            try:
                op = req[0] if isinstance(req, tuple) and req else "?"
                if remote_deadline is not None and remote_deadline.expired():
                    # the caller has already given up: reject BEFORE burning
                    # a dispatch (store transaction, kernel launch)
                    server.metrics.inc("rpc.server",
                                       "deadline-expired-rejections")
                    raise DeadlineExceeded(
                        f"rpc.{op} arrived with its deadline expired")
                span_cm = (server.tracer.start_span(f"rpc.{op}",
                                                    child_of=remote_ctx)
                           if remote_ctx is not None else nullcontext())
                # bind the remaining budget for the dispatch, so every
                # outbound hop this handler makes (store writes, peer
                # engines) inherits the shrinking deadline
                with span_cm, deadline_mod.bind(remote_deadline):
                    result, matched_poll = self._dispatch(server, req)
                response = ("ok", result)
            except CircuitOpenError as exc:
                # an outbound dependency of this host is being shed: the
                # caller sees a typed busy signal, not a mystery
                # ConnectionError (degrade, don't queue behind a dead host)
                response = ("err", ServiceBusy(str(exc)))
            except BaseException as exc:
                response = ("err", exc)
            try:
                send_frame(self.request, response)
            except (OSError, ConnectionError):
                if matched_poll is not None:
                    # a matched task delivered to a dead socket (worker
                    # died mid-long-poll) must requeue, not vanish
                    server.matching.local.requeue_task(*matched_poll)
                return
            except Exception:
                # unpicklable result/exception: degrade to a string error
                # rather than killing the connection
                try:
                    send_frame(self.request,
                               ("err", RuntimeError(repr(response[1]))))
                except Exception:
                    return

    @staticmethod
    def _dispatch(server: "ServiceHost", req) -> Tuple[object, Optional[tuple]]:
        """Execute one op → (result, matched_poll)."""
        matched_poll = None
        op = req[0]
        if op == "frontend":
            _, method, args, kwargs = req
            result = getattr(server.frontend, method)(*args, **kwargs)
        elif op == "engine":
            _, workflow_id, path, args, kwargs = req
            target = server.controller.engine_for_workflow(workflow_id)
            for part in path.split("."):
                target = getattr(target, part)
            result = target(*args, **kwargs)
        elif op == "engine_routed":
            # cross-CLUSTER entry: any host accepts and forwards to
            # its ring's owner (server.route), so a peer cluster
            # needs only one live address, not our ring topology
            _, workflow_id, path, args, kwargs = req
            target = server.route(workflow_id)
            for part in path.split("."):
                target = getattr(target, part)
            result = target(*args, **kwargs)
        elif op == "matching":
            _, method, args, kwargs = req
            result = getattr(server.matching.local, method)(*args, **kwargs)
            if method in _MATCHING_POLLS and result is not None:
                matched_poll = (result, _MATCHING_POLLS[method])
        elif op == "admin_stale_probe":
            # deposed-owner fencing probe: write through the CACHED
            # shard engine, bypassing ring validation — the range
            # fence in the store server must reject it
            _, domain_id, workflow_id = req
            sid = server.controller.shard_for(workflow_id)
            engine = server.controller.cached_engine(sid)
            if engine is None:
                raise RuntimeError(f"no cached engine for shard {sid}")
            engine.signal_workflow(domain_id, workflow_id, "stale-probe")
            result = None
        elif op == "admin_metrics":
            # the scrape surface as an RPC (operator tooling that already
            # speaks the wire need not open the HTTP port)
            server.publish_launches()
            result = {"snapshot": server.metrics.snapshot(),
                      "prometheus": server.metrics.to_prometheus()}
        elif op == "admin_cluster":
            # per-host cluster rollup (the `admin cluster` CLI verb's
            # wire leg): shard ownership, serving/resident/migration
            # occupancy — and with detail=True the resident rows' payload
            # CRCs, the byte-parity probe the planned-rebalance test
            # compares losing-host→gaining-host→oracle
            detail = bool(req[1]) if len(req) > 1 else False
            result = server.cluster_doc(detail=detail)
        elif op == "admin_drain":
            # planned-rebalance drain (engine/migration.py): persist a
            # snapshot record for every resident row on this host so a
            # following kill/rebalance is a warm failover by construction
            if server.migration is None:
                raise RuntimeError("serving tier (and migration) not "
                                   "enabled on this host")
            evict = bool(req[1]) if len(req) > 1 else False
            rep = server.migration.drain_host(evict=evict)
            result = {"shards": rep.shards, "considered": rep.considered,
                      "snapshotted": rep.snapshotted,
                      "skipped": rep.skipped, "evicted": rep.evicted}
        elif op == "admin_prehydrate":
            # warm-promotion hydration (the `load region` scenario's
            # per-host leg): only the leader host sees the replicated
            # domain flip, so every standby host exposes hydration as a
            # wire op — seed_caches + suffix replay over its OWN shards
            if server.migration is None:
                raise RuntimeError("serving tier (and migration) not "
                                   "enabled on this host")
            rep = server.migration.hydrate_shards(
                server.controller.owned_shards())
            result = {"shards": rep.shards, "considered": rep.considered,
                      "hydrated": rep.hydrated,
                      "suffix_events": rep.suffix_events,
                      "cold": rep.cold, "young": rep.young,
                      "stale": rep.stale,
                      "already_resident": rep.already_resident,
                      "parity_divergence": rep.parity_divergence}
        elif op == "admin_dlq":
            # DLQ rollup / redrive over the wire (the `admin dlq` and
            # `dlq redrive` CLI verbs' wire legs). Consumers live on the
            # leader host; a non-leader still answers with a read-only
            # processor over its cluster's shared stores
            sub = req[1] if len(req) > 1 else "summary"
            if server._xdc_consumers:
                proc = server._xdc_consumers[0].repl
            else:
                from ..engine.replication import (
                    HistoryReplicator as _HR,
                    ReplicationPublisher as _RP,
                    ReplicationTaskProcessor as _RTP,
                )
                proc = _RTP(_HR(server.stores), _RP(server.stores),
                            server.stores)
                proc.metrics = server.metrics
            if sub == "redrive":
                result = proc.redrive_dlq()
            else:
                result = proc.dlq_summary()
        elif op == "admin_partition":
            # per-peer-pair partition control (rpc/chaos.PartitionTable):
            # ("admin_partition", "block"|"heal", host, port) severs or
            # restores THIS host's outbound leg to one endpoint —
            # asymmetric by construction, since the reverse direction
            # lives in the peer's own table; "heal_all" and "list" manage
            # campaign teardown/inspection. The admin call itself rides
            # campaign-client → this host, so a host partitioned from
            # the store stays controllable.
            sub = req[1] if len(req) > 1 else "list"
            table = chaos_mod.partitions()
            if sub == "block":
                table.block(req[2], int(req[3]))
            elif sub == "heal":
                table.heal(req[2], int(req[3]))
            elif sub == "heal_all":
                table.heal_all()
            elif sub != "list":
                raise ValueError(f"unknown admin_partition arm {sub!r}")
            result = {"host": server.name, "pairs": table.pairs(),
                      **table.counts()}
        elif op == "admin_timeseries":
            # the /timeseries doc over the wire (operator tooling that
            # already speaks the protocol need not open the HTTP port)
            result = server.timeseries_doc(
                req[1] if len(req) > 1 else 120)
        elif op == "admin_hostprof":
            result = server.hostprof_doc(
                float(req[1]) if len(req) > 1 else 0.0)
        elif op == "admin_flightrec":
            result = server.flightrec_doc(
                req[1] if len(req) > 1 else 200)
            dump = req[2] if len(req) > 2 else None
            if dump:
                result["dumped"] = flightrecorder.DEFAULT_RECORDER.dump(
                    dump, reason="admin")
        elif op == "ping":
            result = ("pong", server.name,
                      server.controller.owned_shards(),
                      server.ring.members())
        else:
            raise ValueError(f"unknown op {op!r}")
        return result, matched_poll


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cadence-tpu-host")
    p.add_argument("--name", required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--store", required=True, help="HOST:PORT of store server")
    p.add_argument("--num-shards", type=int, default=8)
    p.add_argument("--hb-interval", type=float, default=0.15)
    p.add_argument("--ttl", type=float, default=3.0)
    p.add_argument("--cluster-name", default="primary")
    p.add_argument("--peer", action="append", default=[],
                   help="peer cluster as NAME=STOREHOST:PORT (repeatable)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (0.0.0.0 in containers)")
    p.add_argument("--advertise-host", default="",
                   help="address peers dial to reach this host (defaults "
                        "to --host, or 127.0.0.1 when binding 0.0.0.0; "
                        "containers pass their service name)")
    p.add_argument("--http-port", type=int, default=0,
                   help="HTTP scrape port (/metrics, /health, /traces); "
                        "0 binds an ephemeral port")
    p.add_argument("--device", default=None,
                   help="device of the host's device tier (cuda, cuda:N, "
                        "cpu); default the card")
    args = p.parse_args(argv)
    shost, sport = args.store.rsplit(":", 1)
    peers = {}
    for spec in args.peer:
        pname, paddr = spec.split("=", 1)
        ph, pp = paddr.rsplit(":", 1)
        peers[pname] = (ph, int(pp))
    advertise = args.advertise_host or (
        args.host if args.host != "0.0.0.0" else "127.0.0.1")
    host = ServiceHost(args.name, (args.host, args.port),
                       (shost, int(sport)), args.num_shards,
                       hb_interval=args.hb_interval, ttl=args.ttl,
                       cluster_name=args.cluster_name, peers=peers,
                       advertise_host=advertise, http_port=args.http_port,
                       device=args.device)
    host.start()
    threading.Event().wait()  # serve until killed
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
