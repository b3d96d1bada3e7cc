"""Counters, timers, gauges and histograms behind (scope, name) keys, under
the JAX package's scope and metric names: the device layers (the
escalation ladder, the native wirec dispatcher, the bulk executor, the
device rebuilder, the replay engine, the pack cache, the resident pool,
the serving scheduler, the snapshot tier, the device visibility view, the
replay profiler, shard migration and the replication pump) and the host
control plane (frontend, history engine, matching, the queues, the system
workers, quotas and the telemetry plane).

Histograms are fixed-bucket (prometheus `le` semantics) with interpolated
percentiles, as in the JAX package. Two emitter seams: snapshot() (the
structured dump) and to_prometheus() (text exposition format 0.0.4, served
by the /metrics surface in utils/scrape.py). Thread-safe; scopes are cheap
handles over the registry.
"""
from __future__ import annotations

import bisect
import re
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: the replay profiler's default scope (utils/profiler.py)
SCOPE_TPU_REPLAY = "tpu.replay-engine"
#: the device rebuilder (engine/rebuild.py): its own profiler legs and
#: device-rebuilds / oracle-fallbacks counters
SCOPE_REBUILD = "tpu.device-rebuilder"
#: the content-addressed pack cache (engine/cache.py PackCache)
SCOPE_PACK_CACHE = "tpu.pack-cache"
#: capacity-escalation ladder (engine/ladder.py)
SCOPE_TPU_FALLBACK = "tpu.fallback"
#: the bulk executor (engine/executor.py): chunks-dispatched,
#: rows-dispatched, pack-queue-wait and the device-busy gauge, with a
#: per-device series (device_metric) when it runs over a mesh
SCOPE_TPU_EXECUTOR = "tpu.executor"
#: persisted mutable-state snapshots (engine/snapshot.py): records found
#: stale or torn are counted and never served
SCOPE_TPU_SNAPSHOT = "tpu.snapshot"
#: the HBM-resident state pool (engine/resident.py ResidentStateCache):
#: exact and suffix hits, misses, invalidations, evictions, events
#: appended, widened and re-narrowed rows, and the bytes/entries/budget
#: gauges (with a -dev{d} bytes series under a sharded pool)
SCOPE_TPU_RESIDENT = "tpu.resident"
#: the micro-batching serving scheduler (engine/serving.py): committed
#: transactions coalesce into one from-state launch per owning device
SCOPE_TPU_SERVING = "tpu.serving"
#: the native (C++) wirec encoder seam (native/wirec.py): the `available`
#: gauge says whether the compiled library loads in this process,
#: native-packs / python-packs count which encoder served each pack
SCOPE_TPU_NATIVE = "tpu.native"
#: the columnar device visibility tier (engine/visibility_device.py +
#: ops/scan.py): List/Scan/Count served as vectorized mask kernels over
#: device-resident columns; counters below under M_VIS_*
SCOPE_TPU_VISIBILITY = "tpu.visibility"
#: the standby's replication pump (engine/replication.py
#: ReplicationTaskProcessor): applied, deduped, resent and quarantined
#: tasks, the device standby apply, shipped snapshots and the per-domain
#: backpressure; counters below under M_REPL_*
SCOPE_REPLICATION = "replication.task-processor"
#: live HBM state migration across the host cluster (engine/migration.py
#: MigrationManager): shard movement snapshots resident rows out of the
#: losing host and hydrates them on the gaining host; counters below
#: under M_MIG_*
SCOPE_TPU_MIGRATION = "tpu.migration"
#: the host control plane (engine/history_engine.py, frontend.py,
#: matching.py, queues.py, workers.py; metrics/defs.go analog)
SCOPE_HISTORY_START_WORKFLOW = "history.start-workflow-execution"
SCOPE_HISTORY_DECISION_COMPLETED = "history.respond-decision-task-completed"
SCOPE_HISTORY_ACTIVITY_RESPOND = "history.respond-activity-task"
SCOPE_HISTORY_SIGNAL = "history.signal-workflow-execution"
SCOPE_HISTORY_RESET = "history.reset-workflow-execution"
SCOPE_FRONTEND_START = "frontend.start-workflow-execution"
SCOPE_FRONTEND_SIGNAL = "frontend.signal-workflow-execution"
SCOPE_QUEUE_TRANSFER = "queue.transfer"
SCOPE_QUEUE_TIMER = "queue.timer"
SCOPE_WORKER_RETENTION = "worker.retention"
SCOPE_WORKER_SCAVENGER = "worker.scavenger"
SCOPE_WORKER_SCANNER = "worker.scanner"
SCOPE_HISTORY_RECORD_STARTED = "history.record-decision-task-started"
SCOPE_FRONTEND_POLL_DECISION = "frontend.poll-for-decision-task"
SCOPE_FRONTEND_RESET = "frontend.reset-workflow-execution"
SCOPE_FRONTEND_QUERY = "frontend.query-workflow"
SCOPE_FRONTEND_READ = "frontend.read"
SCOPE_MATCHING_POLL_DECISION = "matching.poll-decision-task"
SCOPE_MATCHING_ADD_DECISION = "matching.add-decision-task"
#: the admission-control seat (utils/quotas.py): every frontend API charged
#: against the multi-stage limiter counts here, `admitted`/`shed` totals
#: plus per-domain series (domain_metric)
SCOPE_QUOTAS = "quotas"
#: the load generator's scopes ride "loadgen.<op-kind>"
SCOPE_LOADGEN_PREFIX = "loadgen"
#: host-runtime attribution (utils/hostprof.py HostProfiler): per-subsystem
#: wall/CPU shares, the GIL-contention estimate and the attributed-share gate
SCOPE_HOSTPROF = "host.prof"
#: ring-buffer sampler health (utils/timeseries.py TimeSeriesSampler)
SCOPE_TIMESERIES = "timeseries"
#: flight-recorder ring (utils/flightrecorder.py): events recorded and dumps
SCOPE_FLIGHTREC = "flightrec"
#: SLO burn rates over the ring-buffer windows
SCOPE_SLO = "slo"
#: hashring membership as observed by one host: drop/join counters and the
#: ring-generation gauge
SCOPE_MEMBERSHIP = "membership"
#: shard controller (engine/controller.py): fenced-engine evictions
SCOPE_CONTROLLER = "controller"

M_REQUESTS = "requests"
M_ERRORS = "errors"
M_TASKS_PROCESSED = "tasks-processed"
M_TASKS_DROPPED_NOT_EXISTS = "tasks-dropped-entity-not-exists"
#: executor dropped a task whose workflow a peer cluster's promotion
#: already owns (version arbitration rejected the local mutation)
M_TASKS_DROPPED_STALE = "tasks-dropped-stale-version"
#: domain-metadata failover-version arbitration: applied mutations, stale
#: ones rejected, duplicate replays at the same failover version
M_DOMREPL_APPLIED = "domain-applied"
M_DOMREPL_STALE_REJECTED = "domain-stale-rejected"
M_DOMREPL_DUPLICATE = "domain-duplicate"
#: membership-flap witnesses (SCOPE_MEMBERSHIP)
M_RING_DROPS = "ring-drops"
M_RING_JOINS = "ring-joins"
M_RING_GENERATION = "ring-generation"
#: fenced-engine evictions (SCOPE_CONTROLLER)
M_FENCED_EVICTIONS = "fenced-evictions"
M_BUFFERED_FLUSHED = "buffered-events-flushed"
M_RATE_LIMITED = "requests-rate-limited"
M_RUNS_DELETED = "runs-deleted"
M_RUNS_ARCHIVED = "runs-archived"
M_EXECUTIONS_SCANNED = "executions-scanned"
M_INVARIANT_VIOLATIONS = "invariant-violations"
#: admission-control counters (SCOPE_QUOTAS): requests the multi-stage
#: limiter admitted vs shed (typed ServiceBusyError with retry-after)
M_QUOTA_ADMITTED = "admitted"
M_QUOTA_SHED = "shed"

M_LATENCY = "latency"
M_KERNEL_LAUNCHES = "kernel-launches"
M_EVENTS_REPLAYED = "events-replayed"
M_REPLAY_THROUGHPUT = "replay-events-per-sec"
M_DEVICE_REBUILDS = "device-rebuilds"
M_ORACLE_FALLBACKS = "oracle-fallbacks"
M_FALLBACK_RATE = "fallback-rate"
#: replay-profiler legs (utils/profiler.py): per-launch host cost
M_PROFILE_PACK = "pack"
M_PROFILE_H2D = "h2d"
M_PROFILE_KERNEL = "kernel"
M_PROFILE_READBACK = "readback"
#: time the device consumer waits on the pack producer pipeline
#: (engine/executor.py): a growing leg means the host packers starve the
#: device; near zero means the device is the bottleneck
M_PROFILE_PACK_WAIT = "pack-queue-wait"
#: gather + widened-K re-replay of flagged rows (engine/ladder.py),
#: observed in seconds per rung
M_PROFILE_FALLBACK = "fallback"
#: the serving tier's flush leg (engine/serving.py), per drain cycle
M_PROFILE_SERVING = "serving"
M_H2D_BYTES = "h2d-bytes"
#: rows entering the ladder, rows resolved on the card, rows left for
#: the oracle; rows re-replayed at each rung are ladder_rung_rows(r)
M_LADDER_FLAGGED = "flagged-rows"
M_LADDER_RESOLVED = "resolved-rows"
M_LADDER_RESIDUAL = "residual-oracle-rows"
#: executor counters (SCOPE_TPU_EXECUTOR): chunks dispatched, and the
#: in-flight chunk count as the device-busy gauge
M_EXEC_CHUNKS = "chunks-dispatched"
M_EXEC_ROWS = "rows-dispatched"
M_EXEC_DEVICE_BUSY = "device-busy"
#: pack-cache counters (SCOPE_PACK_CACHE)
M_CACHE_HITS = "hits"
M_CACHE_MISSES = "misses"
M_CACHE_EVICTIONS = "evictions"
M_CACHE_SUFFIX_PACKS = "suffix-packs"
#: resident-pool counters and gauges (SCOPE_TPU_RESIDENT; hits, misses
#: and evictions under the pack cache's names above): invalidations count
#: stale entries dropped on a tail overwrite, reset or NDC branch switch
M_CACHE_INVALIDATIONS = "invalidations"
M_RESIDENT_SUFFIX_HITS = "suffix-hits"
M_RESIDENT_BYTES = "resident-bytes"
M_RESIDENT_ENTRIES = "resident-entries"
M_RESIDENT_BUDGET_BYTES = "budget-bytes"
M_RESIDENT_EVENTS_APPENDED = "events-appended"
M_RESIDENT_WIDENED = "widened-rows"
M_RESIDENT_NARROWED = "renarrowed-rows"
#: serving-tier counters, histograms and the queue gauge
#: (SCOPE_TPU_SERVING): transactions / batched-launches is the coalescing
#: factor; parity-divergence counts device payloads that disagreed with
#: the oracle's committed row (the entry is dropped, never served)
M_SERVING_TXNS = "transactions"
M_SERVING_LAUNCHES = "batched-launches"
M_SERVING_COALESCED = "coalesced-appends"
M_SERVING_BATCH_SIZE = "batch-size"
M_SERVING_QUEUE_WAIT = "queue-wait"
M_SERVING_DIVERGENCE = "parity-divergence"
M_SERVING_EXACT = "exact-serves"
M_SERVING_SUFFIX = "suffix-appends"
M_SERVING_COLD = "cold-admits"
M_SERVING_BYPASSED = "bypassed"
M_SERVING_REQUEUED = "requeued"
M_SERVING_REJECTED = "busy-rejections"
M_SERVING_QUEUE_DEPTH = "queue-depth"
#: snapshot tier (SCOPE_TPU_SNAPSHOT): checksum-gated writes, writes
#: refused by the checksum gate, hydrations into the resident pool,
#: records skipped as stale (format, layout or address) or torn (blob
#: CRC), and the store's occupancy gauges
M_SNAP_WRITES = "writes"
M_SNAP_CHECKSUM_SKIPS = "checksum-skips"
M_SNAP_HYDRATES = "hydrates"
M_SNAP_IGNORED_STALE = "ignored-stale"
M_SNAP_IGNORED_TORN = "ignored-torn"
M_SNAP_BYTES = "snapshot-bytes"
M_SNAP_ENTRIES = "snapshot-entries"
M_REPL_APPLIED = "replication-applied"
M_REPL_DEDUPED = "replication-deduped"
M_REPL_RESENT = "replication-resends"
M_REPL_DLQ = "replication-dlq"
#: replication DLQ depth gauge: current quarantined-entry count on the
#: target store (maintained at every enqueue/redrive/purge touch point)
M_REPL_DLQ_DEPTH = "dlq-depth"
#: DLQ redrive: entries re-applied through the resender by
#: ReplicationTaskProcessor.redrive_dlq
M_REPL_REDRIVEN = "replication-redriven"
#: device standby apply (engine/replication.py _DeviceApplier): applied
#: histories streamed through the resident tier at the bulk-ingest rate,
#: host-parity gated per apply — divergence counted, never served
M_REPL_DEVICE_APPLIED = "device-applied"
M_REPL_DEVICE_SUFFIX_EVENTS = "device-suffix-events"
M_REPL_DEVICE_COLD = "device-skipped-cold"
M_REPL_DEVICE_STALE = "device-skipped-stale"
M_REPL_DEVICE_DIVERGENCE = "device-parity-divergence"
M_REPL_DEVICE_UNSTABLE = "device-parity-skipped-unstable"
#: snapshot-shipping replication: checksum-gated SnapshotRecords riding
#: the replication stream so a standby's cold admits are seed_caches +
#: suffix replay, never full replay
M_REPL_SNAP_SHIPPED = "snapshots-shipped"
M_REPL_SNAP_INSTALLED = "snapshots-installed"
M_REPL_SNAP_IGNORED_TORN = "snapshots-ignored-torn"
M_REPL_SNAP_IGNORED_STALE = "snapshots-ignored-stale"
M_REPL_SNAP_IGNORED_FOREIGN = "snapshots-ignored-foreign"
#: per-domain replication backpressure: a drain pass stops (typed
#: ReplicationBackpressureShed) once one domain has consumed its per-pass
#: apply budget; -deferred counts the tasks the shed pass left for the
#: next pass
M_REPL_BP_SHED = "backpressure-shed"
M_REPL_BP_DEFERRED = "backpressure-deferred"
#: live HBM state migration (SCOPE_TPU_MIGRATION): on shard RELEASE the
#: losing host writes checksum-gated snapshot records for its moving
#: resident rows (`migrated-out`; gate-refused writes count
#: `migrate-out-skipped`) and drops the local entries (`evicted-resident`);
#: on shard ACQUIRE the gaining host hydrates the stolen shards' open
#: workflows from the shared snapshot store — `migrated-in` counts
#: snapshot-hydrated admits (suffix catch-up events under
#: `suffix-events`), `cold-steals` keys with no usable record,
#: `stale-snapshots` records whose address no longer prefixes the stored
#: bytes. `parity-divergence` counts hydrated rows whose payload disagreed
#: with the oracle's live state over a STABLE store (dropped, never
#: served); `parity-skipped-unstable` counts comparisons skipped because a
#: foreign commit moved the tail mid-hydration (not divergence).
M_MIG_OUT = "migrated-out"
M_MIG_OUT_SKIPPED = "migrate-out-skipped"
M_MIG_EVICTED = "evicted-resident"
M_MIG_IN = "migrated-in"
M_MIG_COLD = "cold-steals"
#: record-less keys at/under the young floor (migration.YOUNG_BATCHES):
#: expected-cold per the snapshot policy's own min_events floor, kept out
#: of the warm-failover ratio
M_MIG_YOUNG = "young-steals"
M_MIG_STALE = "stale-snapshots"
M_MIG_SUFFIX_EVENTS = "suffix-events"
M_MIG_DIVERGENCE = "parity-divergence"
M_MIG_UNSTABLE = "parity-skipped-unstable"
#: the counters a serving host pre-registers at 0, so that "no divergence"
#: and "series missing" scrape apart (the JAX package's rpc/server.py
#: ServiceHost registers the same names)
MIGRATION_COUNTERS = (M_MIG_OUT, M_MIG_OUT_SKIPPED, M_MIG_EVICTED, M_MIG_IN, M_MIG_COLD,
                      M_MIG_YOUNG, M_MIG_STALE, M_MIG_SUFFIX_EVENTS, M_MIG_DIVERGENCE,
                      M_MIG_UNSTABLE)
REPLICATION_COUNTERS = (M_REPL_APPLIED, M_REPL_DEDUPED, M_REPL_RESENT, M_REPL_DLQ,
                        M_REPL_REDRIVEN, M_REPL_DEVICE_APPLIED, M_REPL_DEVICE_SUFFIX_EVENTS,
                        M_REPL_DEVICE_COLD, M_REPL_DEVICE_STALE, M_REPL_DEVICE_DIVERGENCE,
                        M_REPL_DEVICE_UNSTABLE, M_REPL_SNAP_SHIPPED, M_REPL_SNAP_INSTALLED,
                        M_REPL_SNAP_IGNORED_TORN, M_REPL_SNAP_IGNORED_STALE,
                        M_REPL_SNAP_IGNORED_FOREIGN, M_REPL_BP_SHED, M_REPL_BP_DEFERRED)
M_NATIVE_AVAILABLE = "available"
M_NATIVE_PACKS = "native-packs"
M_NATIVE_PY_PACKS = "python-packs"

#: columnar device visibility tier (engine/visibility_device.py,
#: SCOPE_TPU_VISIBILITY): `queries` counts every routed List/Scan/Count,
#: split into `device-served` (mask kernel answered) vs `host-fallbacks`
#: (evaluated on the host instead — `fallback-predicate` the query uses
#: an op/column the kernels can't express (e.g. string ordering),
#: `fallback-column` a search-attribute column past the intern budget or
#: type-poisoned). `parity-divergence` counts device answers that
#: disagreed with the host oracle (served the HOST answer, gated at 0);
#: `topk-serves` vs `bitmap-scans` splits paged readback strategies,
#: `topk-escalations` counts pages that re-ran through the bitmap path
#: (boundary tie / truncation). `deltas-applied`/`drains` meter the
#: coalescing appender; `staleness-pending` is the backlog a query
#: observed before its flush (the recorded staleness gauge), and
#: `rows`/`attr-columns`/`interned-strings` mirror column occupancy.
M_VIS_QUERIES = "queries"
M_VIS_DEVICE_SERVED = "device-served"
M_VIS_HOST_FALLBACKS = "host-fallbacks"
M_VIS_FALLBACK_PREDICATE = "fallback-predicate"
M_VIS_FALLBACK_COLUMN = "fallback-column"
M_VIS_PARITY_CHECKS = "parity-checks"
M_VIS_DIVERGENCE = "parity-divergence"
M_VIS_TOPK = "topk-serves"
M_VIS_BITMAP = "bitmap-scans"
M_VIS_TOPK_ESCALATIONS = "topk-escalations"
M_VIS_DELTAS = "deltas-applied"
M_VIS_DRAINS = "drains"
M_VIS_STALENESS = "staleness-pending"
M_VIS_ROWS = "rows"
M_VIS_ATTR_COLUMNS = "attr-columns"
M_VIS_INTERNED = "interned-strings"
M_VIS_SCAN_LATENCY = "scan-latency"
#: LFU attr-column swaps: an over-budget search attribute out-demanded
#: the least-queried resident column and took its slot — queries on it
#: stop permanently falling back (visibility_device._maybe_replace_attr)
M_VIS_ATTR_REPLACEMENTS = "attr-column-replacements"


def preregister_migration(registry: "MetricsRegistry") -> None:
    """MIGRATION_COUNTERS at 0 under SCOPE_TPU_MIGRATION, as a serving host
    registers them when it wires its MigrationManager."""
    for metric in MIGRATION_COUNTERS:
        registry.inc(SCOPE_TPU_MIGRATION, metric, 0)


def preregister_replication(registry: "MetricsRegistry") -> None:
    """REPLICATION_COUNTERS at 0 and the DLQ depth gauge at 0 under
    SCOPE_REPLICATION, as a host registers them when it wires its
    replication pump (the JAX package's list also holds the
    domain-replication counters, whose module the port does not have)."""
    for metric in REPLICATION_COUNTERS:
        registry.inc(SCOPE_REPLICATION, metric, 0)
    registry.gauge(SCOPE_REPLICATION, M_REPL_DLQ_DEPTH, 0.0)


def ladder_rung_rows(rung: int) -> str:
    """Per-rung row counter name: rows-rung1, rows-rung2, ..."""
    return f"rows-rung{rung}"


def device_metric(name: str, device: int) -> str:
    """Per-device series name: chunks-dispatched-dev0, device-busy-dev3,
    ...: the mesh position rides the flat (scope, name) key."""
    return f"{name}-dev{device}"


def domain_metric(name: str, domain: str) -> str:
    """Per-domain series name: shed-domain-hot, latency-domain-payments,
    ...: the domain label rides the flat (scope, name) key like
    device_metric's device label (to_prometheus sanitizes it)."""
    return f"{name}-domain-{domain}"


#: latency buckets (seconds): sub-millisecond paths through multi-second
#: device work
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

#: byte-size buckets (host-to-device transfer sizes: KBs to 256 MB)
BYTE_BUCKETS: Tuple[float, ...] = (
    1024.0, 16384.0, 262144.0, 1048576.0, 16777216.0, 268435456.0)


class HistogramStat:
    """Fixed-bucket histogram (bucket i counts values <= bounds[i]; the
    last slot is +Inf)."""

    __slots__ = ("bounds", "bucket_counts", "count", "total")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self.bucket_counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.bucket_counts[bisect.bisect_left(self.bounds, value)] += 1

    def cumulative(self) -> List[Tuple[str, int]]:
        """[(le_label, cumulative_count)] ending with ("+Inf", count)."""
        out: List[Tuple[str, int]] = []
        running = 0
        for bound, n in zip(self.bounds, self.bucket_counts):
            running += n
            out.append((str(bound), running))
        out.append(("+Inf", self.count))
        return out

    def percentile(self, q: float) -> float:
        """q in [0, 1]; linear interpolation inside the covering bucket.
        Values in the +Inf bucket clamp to the top finite bound."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        running = 0
        lo = 0.0
        for bound, n in zip(self.bounds, self.bucket_counts):
            if n and running + n >= target:
                return lo + (bound - lo) * ((target - running) / n)
            running += n
            lo = bound
        return self.bounds[-1]


@dataclass
class _TimerStat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)


class MetricsRegistry:
    """In-process aggregates keyed by (scope, name)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], int] = {}
        self._timers: Dict[Tuple[str, str], _TimerStat] = {}
        self._gauges: Dict[Tuple[str, str], float] = {}
        self._histograms: Dict[Tuple[str, str], HistogramStat] = {}

    def scope(self, name: str) -> "Scope":
        return Scope(self, name)

    def inc(self, scope: str, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[(scope, name)] = self._counters.get((scope, name), 0) + delta

    def record(self, scope: str, name: str, seconds: float) -> None:
        """A timer and its latency histogram, fed together."""
        with self._lock:
            self._timers.setdefault((scope, name), _TimerStat()).record(seconds)
            hist = self._histograms.get((scope, name))
            if hist is None:
                hist = self._histograms[(scope, name)] = HistogramStat()
            hist.observe(seconds)

    def observe(self, scope: str, name: str, value: float,
                buckets: Optional[Sequence[float]] = None) -> None:
        """A histogram-only observation (sizes, per-leg timings);
        `buckets` applies on the series' first touch."""
        with self._lock:
            hist = self._histograms.get((scope, name))
            if hist is None:
                hist = self._histograms[(scope, name)] = HistogramStat(
                    buckets if buckets is not None else DEFAULT_BUCKETS)
            hist.observe(value)

    def gauge(self, scope: str, name: str, value: float) -> None:
        with self._lock:
            self._gauges[(scope, name)] = value

    def counter(self, scope: str, name: str) -> int:
        with self._lock:
            return self._counters.get((scope, name), 0)

    def timer(self, scope: str, name: str) -> _TimerStat:
        with self._lock:
            return self._timers.get((scope, name), _TimerStat())

    def gauge_value(self, scope: str, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get((scope, name), default)

    def histogram(self, scope: str, name: str) -> HistogramStat:
        with self._lock:
            return self._histograms.get((scope, name), HistogramStat())

    def percentiles(self, scope: str, name: str,
                    qs: Sequence[float] = (0.5, 0.95, 0.99)) -> Dict[str, float]:
        hist = self.histogram(scope, name)
        return {f"p{round(q * 100):d}": hist.percentile(q) for q in qs}

    def reset(self) -> None:
        """Drop every series (components hold the registry by reference,
        so clearing in place reaches them all)."""
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._gauges.clear()
            self._histograms.clear()

    def raw_series(self) -> Tuple[Dict, Dict, Dict]:
        """A point-in-time copy of every series, taken under one lock hold:
        (counters, gauges, histograms), each histogram as (count, total,
        bounds, bucket_counts tuple). The time-series sampler and the
        Prometheus renderer both read it, so a concurrent observe() or
        reset() never yields a half-updated view."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = {
                k: (h.count, h.total, h.bounds, tuple(h.bucket_counts))
                for k, h in self._histograms.items()}
        return counters, gauges, histograms

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Every series grouped by scope: a timer as name.count, .total_s
        and .max_s; a histogram as its p50, p95 and p99 (and .count and
        .sum when no timer feeds it)."""
        out: Dict[str, Dict[str, object]] = {}
        with self._lock:
            for (scope, name), v in self._counters.items():
                out.setdefault(scope, {})[name] = v
            for (scope, name), t in self._timers.items():
                out.setdefault(scope, {}).update({
                    f"{name}.count": t.count, f"{name}.total_s": round(t.total_s, 6),
                    f"{name}.max_s": round(t.max_s, 6)})
            for (scope, name), h in self._histograms.items():
                series = out.setdefault(scope, {})
                for q in (0.5, 0.95, 0.99):
                    series[f"{name}.p{round(q * 100):d}"] = round(h.percentile(q), 6)
                if (scope, name) not in self._timers:
                    series[f"{name}.count"] = h.count
                    series[f"{name}.sum"] = round(h.total, 6)
            for (scope, name), v in self._gauges.items():
                out.setdefault(scope, {})[name] = v
        return out

    def to_prometheus(self, prefix: str = "cadence") -> str:
        """Every series in Prometheus text format 0.0.4. The scope is a
        label, the metric name is sanitized into the grammar: counters get
        `_total`, histograms emit `_bucket`/`_sum`/`_count` with `le`
        labels. Renders from raw_series()'s copy, so a histogram's +Inf
        bucket always agrees with its own count."""
        counters, gauges, histograms = self.raw_series()

        def metric_name(name: str) -> str:
            return prefix + "_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)

        def fmt(value: float) -> str:
            return str(int(value)) if float(value).is_integer() else str(value)

        lines: List[str] = []
        typed: set = set()

        def header(mname: str, kind: str) -> None:
            if mname not in typed:
                typed.add(mname)
                lines.append(f"# TYPE {mname} {kind}")

        def by_family(items):
            # all samples of one metric family must be contiguous
            return sorted(items, key=lambda kv: (kv[0][1], kv[0][0]))

        for (scope, name), v in by_family(counters.items()):
            mname = metric_name(name) + "_total"
            header(mname, "counter")
            lines.append(f'{mname}{{scope="{scope}"}} {v}')
        for (scope, name), v in by_family(gauges.items()):
            mname = metric_name(name)
            header(mname, "gauge")
            lines.append(f'{mname}{{scope="{scope}"}} {fmt(v)}')
        for (scope, name), (count, total, bounds, buckets) in by_family(histograms.items()):
            mname = metric_name(name)
            header(mname, "histogram")
            running = 0
            for bound, n in zip(bounds, buckets):
                running += n
                lines.append(f'{mname}_bucket{{scope="{scope}",le="{bound}"}} {running}')
            lines.append(f'{mname}_bucket{{scope="{scope}",le="+Inf"}} {count}')
            lines.append(f'{mname}_sum{{scope="{scope}"}} {fmt(round(total, 9))}')
            lines.append(f'{mname}_count{{scope="{scope}"}} {count}')
        return "\n".join(lines) + ("\n" if lines else "")


class Scope:
    """One named scope over a registry."""

    def __init__(self, registry: MetricsRegistry, name: str) -> None:
        self._r = registry
        self.name = name

    def inc(self, metric: str, delta: int = 1) -> None:
        self._r.inc(self.name, metric, delta)

    def record(self, metric: str, seconds: float) -> None:
        self._r.record(self.name, metric, seconds)

    def gauge(self, metric: str, value: float) -> None:
        self._r.gauge(self.name, metric, value)

    @contextmanager
    def timed(self, metric: str = M_LATENCY):
        start = time.perf_counter()
        try:
            yield
        finally:
            self._r.record(self.name, metric, time.perf_counter() - start)


#: the process-wide registry, for callers that pass none
DEFAULT_REGISTRY = MetricsRegistry()
