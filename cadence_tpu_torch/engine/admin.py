"""Admin/ops surface.

Reference: service/frontend/adminHandler.go — DescribeWorkflowExecution
(raw mutable state + checksum), DescribeHistoryHost, DescribeQueue,
CloseShard, dynamic-config CRUD — plus DescribeCluster-style rollups the
CLI consumes (tools/cli admin commands).
"""
from __future__ import annotations

import json
import time
import urllib.request
from collections import Counter
from typing import Any, Dict, List, Optional

from ..core.checksum import Checksum
from ..utils import flightrecorder
from ..utils import metrics as m
from . import migration as migration_mod
from . import resident as resident_mod
from . import snapshot as snapshot_mod
from . import visibility_device as vd
from .authorization import (PERMISSION_ADMIN, AuthAttributes, NoopAuthorizer,
                            check)
from .persistence import EntityNotExistsError


class AdminHandler:
    """Operator API over one cluster (an Onebox or equivalent wiring).

    Every method passes the authorization seam with PERMISSION_ADMIN
    (accessControlledHandler + authorizer.go:88): the default Noop
    authorizer allows all, but wiring a real one closes the admin
    surface."""

    def __init__(self, box, authorizer=None, actor: str = "") -> None:
        self.box = box
        self.authorizer = (authorizer if authorizer is not None
                           else getattr(box, "authorizer", None)
                           or NoopAuthorizer())
        self.actor = actor

    def _authorize(self, api: str) -> None:
        check(self.authorizer, AuthAttributes(api=f"admin.{api}",
                                              permission=PERMISSION_ADMIN,
                                              actor=self.actor))

    # -- execution introspection (adminHandler DescribeWorkflowExecution) --

    def describe_workflow_execution(self, domain: str, workflow_id: str,
                                    run_id: Optional[str] = None
                                    ) -> Dict[str, Any]:
        """Raw mutable state: execution info, pending tables, version
        histories, buffered events, checksum."""
        self._authorize("describe_workflow_execution")
        stores = self.box.stores
        domain_id = stores.domain.by_name(domain).domain_id
        if run_id is None:
            run_id = stores.execution.get_current_run_id(domain_id, workflow_id)
        ms = stores.execution.get_workflow(domain_id, workflow_id, run_id)
        info = ms.execution_info
        return {
            "execution": {"domain_id": domain_id, "workflow_id": workflow_id,
                          "run_id": run_id},
            "state": int(info.state),
            "close_status": int(info.close_status),
            "next_event_id": info.next_event_id,
            "last_first_event_id": info.last_first_event_id,
            "decision": {
                "schedule_id": info.decision_schedule_id,
                "started_id": info.decision_started_id,
                "attempt": info.decision_attempt,
            },
            "sticky_task_list": info.sticky_task_list,
            "pending_activities": sorted(ms.pending_activity_info_ids),
            "pending_timers": sorted(
                ti.started_id for ti in ms.pending_timer_info_ids.values()),
            "pending_children": sorted(ms.pending_child_execution_info_ids),
            "buffered_events": len(ms.buffered_events),
            "version_histories": {
                "current_index": ms.version_histories.current_index,
                "branches": [
                    [(i.event_id, i.version) for i in h.items]
                    for h in ms.version_histories.histories
                ],
            },
            "checksum": f"0x{Checksum.of(ms).value:08x}",
            "history_length": len(stores.history.read_events(
                domain_id, workflow_id, run_id)),
        }

    # -- host / shard introspection (DescribeHistoryHost, handler.go:741) --

    def describe_history_host(self, host: str) -> Dict[str, Any]:
        self._authorize("describe_history_host")
        controller = self.box.controllers[host]
        shards = sorted(controller.assigned_shards())
        return {"host": host, "shard_count": len(shards),
                "shard_ids": shards,
                "num_shards_total": self.box.num_shards}

    def describe_cluster(self) -> Dict[str, Any]:
        self._authorize("describe_cluster")
        return {
            "cluster": self.box.cluster_name,
            "hosts": {h: self.describe_history_host(h)["shard_count"]
                      for h in self.box.hosts},
            "num_shards": self.box.num_shards,
            "executions": len(self.box.stores.execution.list_executions()),
            "matching_backlog": self.box.matching.backlog(),
            "metrics": self.box.metrics.snapshot(),
        }

    def metrics(self) -> Dict[str, Any]:
        """The scrape surface as an admin call: structured snapshot (with
        percentiles) plus the prometheus text rendering — what the
        ServiceHost `admin_metrics` wire op and GET /metrics serve."""
        self._authorize("metrics")
        return {"snapshot": self.box.metrics.snapshot(),
                "prometheus": self.box.metrics.to_prometheus()}

    # -- queue introspection (DescribeQueue, handler.go:851) ---------------

    def describe_queue(self, shard_id: int) -> Dict[str, Any]:
        self._authorize("describe_queue")
        for controller in self.box.controllers.values():
            try:
                engine = controller.engine_for_shard(shard_id)
            except Exception:
                continue
            shard = engine.shard
            live = []
            for proc in getattr(self.box, "processors", []):
                states = proc.transfer_queue_states(shard_id)
                if states:
                    live = states
                    break
            return {
                "shard_id": shard_id,
                "range_id": shard.range_id,
                "transfer_ack_level": shard.transfer_ack_level,
                "pending_transfer": len(shard.read_transfer_tasks(
                    shard.transfer_ack_level)),
                # multi-level processing queues: live states when a
                # concurrent pump runs here, else the persisted ones
                "processing_queues": (live or shard.transfer_queue_states),
            }
        raise EntityNotExistsError(f"no live owner for shard {shard_id}")

    def close_shard(self, shard_id: int) -> bool:
        """CloseShard (adminHandler): force the owning engine's shard
        closed so the next write fences and ownership re-acquires."""
        self._authorize("close_shard")
        for controller in self.box.controllers.values():
            try:
                engine = controller.engine_for_shard(shard_id)
            except Exception:
                continue
            engine.shard.close()
            return True
        return False

    # -- dynamic config CRUD (adminHandler config commands) ----------------

    def get_dynamic_config(self, key: str,
                           domain: Optional[str] = None) -> Any:
        self._authorize("get_dynamic_config")
        return self.box.config.get(key, domain=domain)

    def update_dynamic_config(self, key: str, value: Any,
                              domain: Optional[str] = None) -> None:
        self._authorize("update_dynamic_config")
        self.box.config.set(key, value, domain=domain)

    # -- maintenance passthroughs ------------------------------------------

    def refresh_workflow_tasks(self, domain: str, workflow_id: str,
                               run_id: Optional[str] = None) -> int:
        self._authorize("refresh_workflow_tasks")
        domain_id = self.box.stores.domain.by_name(domain).domain_id
        return self.box.route(workflow_id).refresh_tasks(domain_id,
                                                         workflow_id, run_id)

    def verify(self, keys: Optional[List] = None):
        """Device bulk verify (the scanner's state invariant, exposed to
        operators like the CLI admin db scan)."""
        self._authorize("verify")
        return self.box.tpu.verify_all(keys)

    def resident(self) -> Dict[str, Any]:
        """Resident-state cache introspection (`admin resident` CLI
        verb): occupancy, hit rates, and HBM budget of the cluster's
        HBM-resident mutable-state cache (engine/resident.py) — the
        operator's view of how much of the fleet's verify/rebuild
        traffic is served incrementally."""
        self._authorize("resident")
        cache = self.box.tpu.resident
        return {
            "enabled": resident_mod.enabled(),
            **cache.stats(),
            "chunk_workflows": cache.chunk_workflows,
            "ladder_max_rungs": (cache.ladder.max_rungs
                                 if cache.ladder is not None else 0),
        }

    def snapshot(self) -> Dict[str, Any]:
        """Snapshot-tier introspection (`admin snapshot` CLI verb,
        mirroring `admin resident`): per-store rollup of record count,
        bytes, the staleness distribution (batches the stored history
        has appended past each snapshot), and the write/hydrate/ignore
        counters — the operator's view of how warm the next restart
        will be."""
        self._authorize("snapshot")
        store = self.box.stores.snapshot
        hs = self.box.stores.history
        staleness: list = []
        for key, rec in store.items():
            stored = hs.batch_count(*key)
            if stored >= rec.batch_count:
                staleness.append(stored - rec.batch_count)
        staleness.sort()

        def pct(q: float) -> int:
            return staleness[min(len(staleness) - 1,
                                 int(len(staleness) * q))] if staleness \
                else 0

        reg = self.box.metrics
        snapper = self.box.tpu.snapshotter()
        return {
            "enabled": snapshot_mod.enabled(),
            **store.stats(),
            "staleness_batches": {
                "p50": pct(0.5), "p99": pct(0.99),
                "max": staleness[-1] if staleness else 0,
            },
            "min_events": snapper.min_events,
            "every_events": snapper.every_events,
            "writes": reg.counter(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_WRITES),
            "checksum_skips": reg.counter(m.SCOPE_TPU_SNAPSHOT,
                                          m.M_SNAP_CHECKSUM_SKIPS),
            "hydrates": reg.counter(m.SCOPE_TPU_SNAPSHOT,
                                    m.M_SNAP_HYDRATES),
            "ignored_stale": reg.counter(m.SCOPE_TPU_SNAPSHOT,
                                         m.M_SNAP_IGNORED_STALE),
            "ignored_torn": reg.counter(m.SCOPE_TPU_SNAPSHOT,
                                        m.M_SNAP_IGNORED_TORN),
        }

    def visibility(self) -> Dict[str, Any]:
        """Device-visibility tier introspection (`admin visibility` CLI
        verb): column occupancy, intern table size, appender backlog,
        the device-served/fallback path mix and parity counters
        (engine/visibility_device.py; the port keeps no kernel-variant
        cache, so the view has no compile-cache hit/miss split) —
        the operator's view of how much List/Scan/Count traffic the
        columnar scan absorbs and how fresh the device view is."""
        self._authorize("visibility")
        store = self.box.stores.visibility
        view = store._device
        out: Dict[str, Any] = {"enabled": vd.enabled(),
                               "attached": view is not None,
                               "parity": vd.parity_enabled()}
        if view is not None:
            out.update(view.stats())
        else:
            reg = self.box.metrics
            out.update({
                "queries": reg.counter(m.SCOPE_TPU_VISIBILITY,
                                       m.M_VIS_QUERIES),
                "parity_divergence": reg.counter(m.SCOPE_TPU_VISIBILITY,
                                                 m.M_VIS_DIVERGENCE),
            })
        return out

    def cluster(self, detail: bool = False) -> Dict[str, Any]:
        """Cluster rollup (`admin cluster` CLI verb, in-process arm):
        per-host shard ownership, resident occupancy, and the migration
        counters (engine/migration.py). `detail` adds each resident
        row's payload CRC32 + branch + content address — the same
        byte-parity probe the wire arm (`admin cluster --host H:P`,
        the `admin_cluster` op) exposes."""
        self._authorize("cluster")
        reg = self.box.metrics
        sc = m.SCOPE_TPU_MIGRATION
        doc: Dict[str, Any] = {
            "cluster": self.box.cluster_name,
            "num_shards": self.box.num_shards,
            "hosts": {h: {"owned_shards": sorted(c.owned_shards()),
                          "assigned_shards": sorted(c.assigned_shards())}
                      for h, c in self.box.controllers.items()},
            "resident": self.box.tpu.resident.stats(),
            "snapshots": self.box.stores.snapshot.stats(),
            "migration": {
                "migrated_out": reg.counter(sc, m.M_MIG_OUT),
                "migrated_in": reg.counter(sc, m.M_MIG_IN),
                "cold_steals": reg.counter(sc, m.M_MIG_COLD),
                "stale_snapshots": reg.counter(sc, m.M_MIG_STALE),
                "parity_divergence": reg.counter(sc, m.M_MIG_DIVERGENCE),
            },
        }
        if detail:
            doc["resident_rows"] = {
                "|".join(key): row for key, row in
                migration_mod.resident_row_checksums(
                    self.box.tpu.resident).items()}
        return doc

    def serving(self) -> Dict[str, Any]:
        """Device-serving tier introspection (`admin serving` CLI verb):
        the micro-batching transaction scheduler's knobs, queue depth,
        coalescing factor, path mix (exact/suffix/cold), backpressure
        and parity counters (engine/serving.py) — plus the resident
        occupancy the tier is maintaining. Reports the wired scheduler
        when the cluster enabled the tier; otherwise a tier-off rollup
        over the engine's (idle) scheduler-to-be."""
        self._authorize("serving")
        scheduler = getattr(self.box, "serving", None)
        if scheduler is None:
            scheduler = self.box.tpu.serving_scheduler()
        return {
            "tier_wired": getattr(self.box, "serving", None) is not None,
            **scheduler.stats(),
            "resident_entries": len(self.box.tpu.resident),
            "resident_bytes": self.box.tpu.resident.resident_bytes,
        }

    # -- cluster telemetry plane (`admin top` / hostprof / flightrec) ------

    def timeseries(self, last_n: int = 120) -> Dict[str, Any]:
        """Ring-buffer windows (`admin top` in-process arm): fold the
        registry's current cumulative state into one more window (the
        box's sampler is constructed-but-not-threaded, anchored at box
        build, so this window spans build→now) and return the doc the
        /timeseries endpoint serves."""
        self._authorize("timeseries")
        sampler = self.box.timeseries
        sampler.sample_once()
        return sampler.doc(last_n)

    def hostprof(self, duration_s: float = 0.5) -> Dict[str, Any]:
        """Host-runtime attribution (`admin hostprof` in-process arm).
        When the box's profiler thread runs, report what it has; else
        burst-sample this process for `duration_s` first."""
        self._authorize("hostprof")
        profiler = self.box.hostprof
        if profiler._thread is None or not profiler._thread.is_alive():
            deadline = time.monotonic() + max(0.0, duration_s)
            while True:
                profiler.sample_once()
                if time.monotonic() >= deadline:
                    break
                time.sleep(profiler.period_s)
        return profiler.rollup()

    def flightrec(self, last_n: int = 100,
                  dump: Optional[str] = None) -> Dict[str, Any]:
        """Flight-recorder snapshot (`admin flightrec` in-process arm):
        ring stats + the trailing events, optionally dumping the full
        ring to a JSONL path on the way out."""
        self._authorize("flightrec")
        recorder = flightrecorder.DEFAULT_RECORDER
        doc: Dict[str, Any] = {"stats": recorder.stats(),
                               "events": recorder.snapshot(last_n),
                               "dumped": None}
        if dump:
            doc["dumped"] = recorder.dump(dump, reason="admin")
        return doc

    def top(self) -> Dict[str, Any]:
        """Single-box `admin top`: the same per-host summary shape
        fleet_top() builds from scraped /timeseries docs, computed over
        this box's sampler (host name "onebox")."""
        self._authorize("top")
        doc = self.timeseries()
        summary = summarize_windows(doc)
        summary["hostprof"] = {
            "attributed_share": self.box.hostprof.attributed_share(),
            "gil_contention": self.box.hostprof.gil_contention(),
        }
        return {"hosts": {"onebox": summary},
                "cluster": _cluster_rollup({"onebox": summary})}


# ---------------------------------------------------------------------------
# Fleet rollup over scraped /timeseries endpoints (`admin top` wire arm)
# ---------------------------------------------------------------------------

def scrape_timeseries(endpoint: str, timeout: float = 5.0) -> Dict[str, Any]:
    """GET one host's /timeseries doc. `endpoint` is host:port or a full
    http:// base."""
    base = endpoint if "://" in endpoint else f"http://{endpoint}"
    with urllib.request.urlopen(f"{base}/timeseries",
                                timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def summarize_windows(doc: Dict[str, Any],
                      horizon_windows: int = 60) -> Dict[str, Any]:
    """One host's /timeseries doc → the `admin top` row: mean
    utilization over the trailing windows, the modal binding resource
    (most-frequent non-idle leg), summed leg seconds, the latest
    window's saturation, and the slo/* burn gauges the burn-rate
    evaluator published into the windows."""
    windows: List[Dict[str, Any]] = list(doc.get("windows", []))
    if not windows:
        return {"windows": 0, "utilization": 0.0,
                "binding_resource": "idle", "legs": {}, "saturation": {},
                "burn": {}, "alerting": False}
    recent = windows[-horizon_windows:]
    utilization = sum(w.get("utilization", 0.0) for w in recent) / len(recent)
    modes = Counter(w.get("binding_resource", "idle") for w in recent
                    if w.get("binding_resource", "idle") != "idle")
    legs: Dict[str, float] = {}
    for w in recent:
        for leg, sec in w.get("legs", {}).items():
            legs[leg] = legs.get(leg, 0.0) + sec
    latest = windows[-1]
    slo_prefix = f"{m.SCOPE_SLO}/"
    burn = {key[len(slo_prefix):]: value
            for key, value in latest.get("gauges", {}).items()
            if key.startswith(slo_prefix)}
    return {
        "windows": len(windows),
        "utilization": round(utilization, 4),
        "binding_resource": (modes.most_common(1)[0][0] if modes
                             else "idle"),
        "legs": {leg: round(sec, 4) for leg, sec in sorted(legs.items())},
        "saturation": latest.get("saturation", {}),
        "burn": burn,
        "alerting": burn.get("alerting", 0.0) > 0.0,
    }


def _cluster_rollup(hosts: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Fleet aggregate + host deltas over per-host summaries: cluster
    utilization (mean), the fleet-wide binding resource (argmax of the
    SUMMED leg seconds — one host's kernel-bound hour outweighs five
    idle peers), and the hot/cold utilization spread that tells an
    operator WHICH host to look at."""
    rows = {h: s for h, s in hosts.items() if "error" not in s}
    if not rows:
        return {"hosts": 0, "utilization": 0.0, "binding_resource": "idle",
                "alerting": False}
    legs: Dict[str, float] = {}
    for summary in rows.values():
        for leg, sec in summary.get("legs", {}).items():
            legs[leg] = legs.get(leg, 0.0) + sec
    utils = {h: s.get("utilization", 0.0) for h, s in rows.items()}
    hot = max(utils, key=utils.get)
    cold = min(utils, key=utils.get)
    return {
        "hosts": len(rows),
        "utilization": round(sum(utils.values()) / len(utils), 4),
        "binding_resource": (max(legs.items(), key=lambda kv: kv[1])[0]
                             if legs else "idle"),
        "legs": {leg: round(sec, 4) for leg, sec in sorted(legs.items())},
        "alerting": any(s.get("alerting") for s in rows.values()),
        "spread": {
            "hot_host": hot, "hot_utilization": round(utils[hot], 4),
            "cold_host": cold, "cold_utilization": round(utils[cold], 4),
            "utilization_delta": round(utils[hot] - utils[cold], 4),
        },
    }


def fleet_top(endpoints: Dict[str, str],
              timeout: float = 5.0) -> Dict[str, Any]:
    """`admin top` over a live cluster: scrape every host's /timeseries,
    summarize each, aggregate. `endpoints` maps host name → host:port
    (rpc/cluster.Cluster.http_ports shape). A host that fails to scrape
    gets an error row instead of sinking the rollup — `admin top` must
    work BEST when the fleet is unhealthy."""
    hosts: Dict[str, Dict[str, Any]] = {}
    for name, endpoint in sorted(endpoints.items()):
        try:
            hosts[name] = summarize_windows(
                scrape_timeseries(endpoint, timeout=timeout))
        except Exception as exc:
            hosts[name] = {"error": f"{type(exc).__name__}: {exc}"}
    return {"hosts": hosts, "cluster": _cluster_rollup(hosts)}
