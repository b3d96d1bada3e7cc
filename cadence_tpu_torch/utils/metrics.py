"""Counters, timers, gauges and histograms behind (scope, name) keys: the
part of the JAX package's utils/metrics.py that the port's device layers
write to (the escalation ladder, the native wirec dispatcher, the bulk
executor, the device rebuilder, the replay engine, the pack cache, the
resident pool, the serving scheduler, the snapshot tier, the device
visibility view and the replay profiler), under the same scope and metric names.

Histograms are fixed-bucket (prometheus `le` semantics) with interpolated
percentiles, as in the JAX package; the Prometheus text exposition of the
full registry stays with the host control plane, which the port has not
taken over yet. Thread-safe; scopes are cheap handles over the registry.
"""
from __future__ import annotations

import bisect
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


def ladder_rung_rows(rung: int) -> str:
    """Per-rung row counter name: rows-rung1, rows-rung2, ..."""
    return f"rows-rung{rung}"


def device_metric(name: str, device: int) -> str:
    """Per-device series name: chunks-dispatched-dev0, device-busy-dev3,
    ...: the mesh position rides the flat (scope, name) key."""
    return f"{name}-dev{device}"


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

    def reset(self) -> None:
        """Drop every series (components hold the registry by reference,
        so clearing in place reaches them all)."""
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._gauges.clear()
            self._histograms.clear()

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
