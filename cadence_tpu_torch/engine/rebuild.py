"""Device-first mutable-state rebuilder: batched replay on the card, then
full MutableState objects on the host.

The reference rebuilds a workflow's mutable state by replaying its full
history through stateBuilder one Go object at a time
(execution/state_rebuilder.go:102 Rebuild). Here the O(events) scan runs
on the card for many workflows at once, through kernel A's task-emitting
variant (ops/replay.replay_events_with_tasks), and the host does only
O(pending) enrichment: the dense final ReplayState carries every
scan-dependent scalar and table, including the timer-created bits that
the task generator sets at batch end, while strings and static start
attributes (activity IDs, task lists, retry policies, parent linkage) are
hydrated from the event batches the caller already holds.

Safety: every hydrated state is checked against the card's own canonical
payload row; a row with a kernel error or a hydration mismatch falls back
to the oracle replayer and is counted. Rows with a capacity error go
through the escalation ladder first (EscalationLadder.escalate_states),
which replays them at widened capacities and keeps those states. The
consumers in the reference: NDC conflict resolution's winning-branch
rebuild, crash-recovery state reconstruction and workflow reset's prefix
replay (reset/resetter.go:96).

This is the JAX package's engine/rebuild.py DeviceRebuilder. Its chunks
fan across the serving mesh (parallel/mesh.py; a mesh of 1 is one card):
each chunk pads to a multiple of the mesh size, its slices are copied to
their devices, and each shard runs its own launches; the ladder's dense
rungs ride the same mesh. Before the device pass it consults persisted
snapshots (`snapshots`: a valid record hydrates into the resident pool)
and the resident pool (`resident`: an exact hit hydrates with no replay,
a suffix hit replays only the appended batches), as the JAX package
does. Without CUDA, and with no device or mesh named, `rebuild` raises:
the JAX rebuilder degrades to the oracle when `serving_mesh()` finds no
backend, the port never does so on its own. `on_device=False` is the
caller's explicit request for the oracle.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout, payload_row
from ..core.enums import EventType
from ..core.events import HistoryBatch, HistoryEvent
from ..device import resolve_device
from ..oracle.mutable_state import (
    ActivityInfo,
    ChildExecutionInfo,
    DomainEntry,
    MutableState,
    RequestCancelInfo,
    SignalInfo,
    TimerInfo,
    VersionHistory,
    VersionHistoryItem,
)
from ..oracle.state_builder import StateBuilder
from ..ops.state import map_state


@dataclass
class RebuildStats:
    """Where rebuilds ran."""

    device: int = 0
    oracle_fallback: int = 0
    #: subset of `device` that resolved through the widened-K escalation
    #: ladder (capacity-flagged histories that stayed on the card)
    ladder: int = 0
    #: subset of `device` served from the resident pool: an exact hit
    #: hydrates with no replay, a suffix hit replays only appended batches
    resident: int = 0
    #: jobs whose resident entry was seeded from a persisted snapshot
    snapshot_seeded: int = 0
    kernel_errors: Dict[int, int] = field(default_factory=dict)

    def merge(self, other: "RebuildStats") -> None:
        self.device += other.device
        self.oracle_fallback += other.oracle_fallback
        self.ladder += other.ladder
        self.resident += other.resident
        self.snapshot_seeded += other.snapshot_seeded
        for code, n in other.kernel_errors.items():
            self.kernel_errors[code] = self.kernel_errors.get(code, 0) + n


def _rebuilt_history_size(batches: Sequence[HistoryBatch], run_id: str) -> int:
    """mutableState GetHistorySize from the stored batches' serialized
    sizes (one batch is one committed transaction is one WAL blob), so a
    rebuilt state keeps its size accounting. For a continue-as-new chain
    only the final run's batches count (the new run starts its own)."""
    from ..core.codec import serialize_history
    return sum(len(serialize_history([b])) for b in batches if b.run_id == run_id)


def _host_state(s):
    """A ReplayState's tensors as numpy arrays, in one copy each."""
    return map_state(lambda t: t.cpu().numpy(), s)


class DeviceRebuilder:
    """Batched device replay → full MutableState objects, on the devices of
    `mesh`, or on `device` (None: the serving mesh over the cards)."""

    def __init__(self, layout: PayloadLayout = DEFAULT_LAYOUT,
                 chunk_jobs: Optional[int] = None, device=None, mesh=None) -> None:
        from ..utils.metrics import DEFAULT_REGISTRY

        self.layout = layout
        self.device = device
        #: the mesh the chunks fan across, resolved on the first device
        #: rebuild (so an oracle-only caller never asks for the card)
        self._mesh = mesh
        self.stats = RebuildStats()
        self.metrics = DEFAULT_REGISTRY
        #: the escalation ladder, made on the first device rebuild (its
        #: device is resolved there, so constructing a rebuilder for an
        #: oracle-only caller never asks for the card)
        self.ladder = None
        #: resident pool to consult before the device pass (a cluster wires
        #: the engine's pool here); None skips the consult unless a
        #: snapshot store is wired, which lazily makes one
        self.resident = None
        #: pack cache whose suffix path encodes resident appends
        from .cache import PackCache
        self.pack_cache = PackCache()
        #: persisted-snapshot store (engine/snapshot.SnapshotStore) a
        #: restart hydrates from
        self.snapshots = None
        #: key -> (snapshot batch count, persisted history_size) of this
        #: rebuilder's seeds: history-size accounting in O(suffix)
        self._snap_sizes: Dict[tuple, Tuple[int, int]] = {}
        #: max jobs per device launch (bounds the [W, E, L] corpus the same
        #: way the replay engine's chunking does)
        self.chunk_jobs = (chunk_jobs if chunk_jobs else
                           int(os.environ.get("CADENCE_TPU_REBUILD_CHUNK", "2048")))
        #: host seconds of the last device rebuild: `device` (the chunk
        #: pipeline: pack, H2D, kernels, readback), `hydrate` (the
        #: MutableStates of the chunks' rows, with their oracle fallbacks)
        #: and `ladder` (the capacity-flagged rows: encode, escalate_states,
        #: readback and hydration)
        self.last_run: Dict[str, float] = {}

    @property
    def mesh(self):
        """The serving mesh (parallel/mesh.serving_mesh), or a mesh of the
        one device the rebuilder was given; raises without CUDA when
        neither names another device."""
        if self._mesh is None:
            from ..parallel.mesh import Mesh, serving_mesh

            self._mesh = (serving_mesh() if self.device is None
                          else Mesh([resolve_device(self.device)]))
        return self._mesh

    def rebuild_one(self, batches: Sequence[HistoryBatch],
                    domain_entry: Optional[DomainEntry] = None) -> MutableState:
        return self.rebuild([(batches, domain_entry)])[0]

    def rebuild(self, jobs: Sequence[Tuple[Sequence[HistoryBatch], Optional[DomainEntry]]],
                on_device: bool = True) -> List[MutableState]:
        """Rebuild one MutableState per job (batches, domain_entry).

        `on_device=False` replays through the oracle and touches no
        device: for read-only callers that should not pay a device replay."""
        from ..utils import metrics as m

        scope = self.metrics.scope(m.SCOPE_REBUILD)
        if not on_device:
            self.stats.oracle_fallback += len(jobs)
            scope.inc(m.M_ORACLE_FALLBACKS, len(jobs))
            self._gauge_fallback_rate()
            return [self._oracle_rebuild(b, e) for b, e in jobs]
        mesh = self.mesh
        dev = mesh.devices[0]
        if not jobs:
            return []
        from ..ops.encode import LANE_EVENT_TYPE, encode_corpus, history_length
        from ..ops.payload import payload_rows
        from ..ops.replay import replay_events_with_tasks
        from ..ops.state import CAPACITY_ERRORS, leaves
        from ..utils.profiler import ReplayProfiler
        from ..parallel.mesh import place_corpus, run_shards
        from .executor import BulkReplayExecutor, queue_shards, wait_for
        from .ladder import EscalationLadder

        if self.ladder is None:
            self.ladder = EscalationLadder(self.layout, registry=self.metrics, device=dev,
                                           mesh=mesh if mesh.size > 1 else None)
        # persisted snapshots first (a warm restart): jobs with a valid
        # record hydrate into the resident pool, so the prepass below
        # serves them as exact or suffix hits
        self._seed_from_snapshots(jobs, dev)
        pre: Dict[int, MutableState] = self._resident_prepass(jobs)
        positions = [i for i in range(len(jobs)) if i not in pre]
        if pre:
            jobs = [jobs[i] for i in positions]
            if not jobs:
                return [pre[i] for i in sorted(pre)]
        # rebuilds profile under their own scope, so a reset or recovery
        # storm is told apart from bulk-verify traffic
        prof = ReplayProfiler(self.metrics, scope=m.SCOPE_REBUILD)

        # chunked through the bulk executor: a recovery storm packs chunk
        # N+1 while chunk N replays, and each chunk's event axis is sized
        # to its own longest history. The chunks fan across the mesh
        chunk_jobs = max(1, self.chunk_jobs)
        spans = [(lo, min(lo + chunk_jobs, len(jobs))) for lo in range(0, len(jobs), chunk_jobs)]
        executor = BulkReplayExecutor(registry=self.metrics, scope=m.SCOPE_REBUILD, mesh=mesh)

        def pack(ci):
            lo, hi = spans[ci]
            chunk = jobs[lo:hi]
            batches = [b for b, _ in chunk]
            corpus = encode_corpus(batches, max(map(history_length, batches)))
            pad_w = -len(chunk) % mesh.size
            if pad_w:
                # a whole slice per device: pad with no-op rows
                pad = np.zeros((pad_w,) + corpus.shape[1:], dtype=corpus.dtype)
                pad[:, :, LANE_EVENT_TYPE] = -1
                corpus = np.concatenate([corpus, pad])
            return corpus, sum(map(history_length, batches))

        def shard(d, ev):
            state, _log = replay_events_with_tasks(ev, self.layout, device=d)
            return state, payload_rows(state, self.layout)

        def launch(ci, packed):
            corpus, chunk_events = packed
            scope.inc(m.M_KERNEL_LAUNCHES)
            scope.inc(m.M_EVENTS_REPLAYED, chunk_events)
            with prof.leg(m.M_PROFILE_H2D):
                parts = place_corpus(corpus, mesh)
                prof.h2d(corpus.nbytes)
            outs = run_shards(mesh, parts, shard)
            # rows and every state tensor, queued to the host behind this
            # chunk's launches
            return outs, queue_shards(mesh.devices, [(r,) + tuple(t for _, t in leaves(s))
                                                     for s, r in outs])

        def consume(ci, launched):
            outs, pulls = launched
            with prof.leg(m.M_PROFILE_KERNEL):
                hosts = wait_for(pulls)
            with prof.leg(m.M_PROFILE_READBACK):
                rows = np.concatenate([h[0].numpy() for h in hosts])
                states = []
                for (s, _), h in zip(outs, hosts):
                    arrays = iter(h[1:])
                    states.append(map_state(lambda _t: next(arrays).numpy(), s))
                if len(states) == 1:
                    return rows, states[0]
                return rows, map_state(lambda *ts: np.concatenate(ts), *states)

        t0 = time.perf_counter()
        with scope.timed():
            results, _report = executor.run(len(spans), pack, launch, consume)
        t1 = time.perf_counter()

        out: List[Optional[MutableState]] = []
        #: capacity-flagged jobs: (position in `out`, batches, entry),
        #: re-replayed at widened K in one batched ladder pass below
        escalate: List[Tuple[int, Sequence[HistoryBatch], Optional[DomainEntry]]] = []
        for (lo, hi), (rows, arrs) in zip(spans, results):
            for i, (batches, entry) in enumerate(jobs[lo:hi]):
                err = int(arrs.error[i])
                if err != 0:
                    self.stats.kernel_errors[err] = self.stats.kernel_errors.get(err, 0) + 1
                    if err in CAPACITY_ERRORS:
                        escalate.append((len(out), batches, entry))
                        out.append(None)
                        continue
                    self.stats.oracle_fallback += 1
                    scope.inc(m.M_ORACLE_FALLBACKS)
                    out.append(self._oracle_rebuild(batches, entry))
                    continue
                ms = self._hydrate(arrs, i, batches, entry)
                if ms is None or not (payload_row(ms, self.layout) == rows[i]).all():
                    # hydration must reproduce the card's canonical payload
                    # exactly; anything else goes to the oracle, counted
                    self.stats.oracle_fallback += 1
                    scope.inc(m.M_ORACLE_FALLBACKS)
                    out.append(self._oracle_rebuild(batches, entry))
                    continue
                self.stats.device += 1
                scope.inc(m.M_DEVICE_REBUILDS)
                out.append(ms)
        t2 = time.perf_counter()

        if escalate:
            corpus = encode_corpus([b for _, b, _ in escalate],
                                   max(history_length(b) for _, b, _ in escalate))
            outcome, states = self.ladder.escalate_states(corpus)
            host: Dict[int, object] = {}  # each rung's state copied to the host once
            for k, (pos, batches, entry) in enumerate(escalate):
                ms = None
                if outcome.resolved[k]:
                    s_k, row_k = states[k]
                    if id(s_k) not in host:
                        host[id(s_k)] = _host_state(s_k)
                    ms = self._hydrate(host[id(s_k)], row_k, batches, entry)
                if ms is not None and (payload_row(ms, self.layout) == outcome.rows[k]).all():
                    self.stats.device += 1
                    self.stats.ladder += 1
                    scope.inc(m.M_DEVICE_REBUILDS)
                    out[pos] = ms
                else:
                    self.stats.oracle_fallback += 1
                    scope.inc(m.M_ORACLE_FALLBACKS)
                    out[pos] = self._oracle_rebuild(batches, entry)
        self.last_run = {"device": t1 - t0, "hydrate": t2 - t1,
                         "ladder": time.perf_counter() - t2}
        self._gauge_fallback_rate()
        return self._merge_prepass(pre, positions, out)

    def _gauge_fallback_rate(self) -> None:
        from ..utils import metrics as m

        done = self.stats.device + self.stats.oracle_fallback
        self.metrics.gauge(m.SCOPE_REBUILD, m.M_FALLBACK_RATE,
                           (self.stats.oracle_fallback / done) if done else 0.0)

    @staticmethod
    def _merge_prepass(pre: Dict[int, MutableState], positions: List[int],
                       device_out: List[MutableState]) -> List[MutableState]:
        """Merge states resolved before the device pass (at `pre`'s job
        positions) with the device pass's states (at `positions`), in job
        order."""
        if not pre:
            return device_out
        merged = dict(pre)
        merged.update(zip(positions, device_out))
        return [merged[i] for i in range(len(merged))]

    def _seed_from_snapshots(self, jobs, device) -> None:
        """Hydrate persisted snapshots into the resident pool for every job
        the pool does not already cover (one pool batch: the rows reach the
        device together). A rebuilder without a wired pool makes its own
        on `device`."""
        from . import resident as resident_mod
        from . import snapshot as snapshot_mod
        from .cache import address_relation

        if self.snapshots is None or not snapshot_mod.enabled() \
                or not resident_mod.enabled() or not len(self.snapshots):
            return
        if self.resident is None:
            self.resident = resident_mod.ResidentStateCache(
                self.layout, ladder=self.ladder, registry=self.metrics, device=device)
        with self.resident.batch():
            for batches, _entry in jobs:
                if not batches:
                    continue
                b0 = batches[0]
                key = (b0.domain_id, b0.workflow_id, b0.run_id)
                entry = self.resident.entry_for(key)
                if entry is not None and address_relation(entry.address, batches) in (
                        "exact", "prefix"):
                    continue  # the pool already covers this lineage
                if snapshot_mod.seed_from_batches(self.snapshots, self.resident,
                                                  self.pack_cache, key, batches, self.layout,
                                                  self.metrics):
                    self.stats.snapshot_seeded += 1
                    rec = self.snapshots.get(key)
                    if rec is not None:
                        self._snap_sizes[key] = (rec.batch_count, rec.history_size)

    def _resident_prepass(self, jobs) -> Dict[int, MutableState]:
        """Resolve jobs out of the resident pool: {job position: hydrated
        MutableState} for every job it could serve, each checked against
        the entry's canonical payload row (a mismatch leaves the job to the
        device pass). Lookups are not authoritative: a rebuild may pass a
        prefix of the stored history (a reset point)."""
        from . import resident as resident_mod
        from ..utils import metrics as m

        cache = self.resident
        if cache is None or not resident_mod.enabled():
            return {}
        resolved: List[tuple] = []  # (pos, key, batches, entry, resident entry)
        suffix_items = []
        suffix_jobs = []
        for pos, (batches, entry) in enumerate(jobs):
            if not batches:
                continue
            b0 = batches[0]
            key = (b0.domain_id, b0.workflow_id, b0.run_id)
            hit = cache.lookup(key, batches, authoritative=False)
            if hit is None:
                continue
            kind, rentry = hit
            if kind == "exact":
                resolved.append((pos, key, batches, entry, rentry))
            else:
                suffix_items.append((key, rentry, batches))
                suffix_jobs.append((pos, batches, entry))
        if suffix_items:
            outcomes = cache.replay_append(
                suffix_items,
                encode_suffix=self.pack_cache.encode_suffix if self.pack_cache is not None
                else None)
            for (pos, batches, entry), (key, _r, _b), res in zip(suffix_jobs, suffix_items,
                                                                  outcomes):
                if not res.ok:
                    continue  # entry invalidated; the device pass takes it
                hit2 = cache.lookup(key, batches, authoritative=False)
                if hit2 is not None and hit2[0] == "exact":
                    resolved.append((pos, key, batches, entry, hit2[1]))
        pre = self._hydrate_resolved(resolved)
        if pre:
            self.stats.device += len(pre)
            self.stats.resident += len(pre)
            self.metrics.scope(m.SCOPE_REBUILD).inc(m.M_DEVICE_REBUILDS, len(pre))
        return pre

    def _hydrate_resolved(self, resolved) -> Dict[int, MutableState]:
        """MutableStates of resident-served rows, each checked against its
        entry's canonical payload. Base-rung rows come back 64 at a time
        from each slab: one kernel-G gather and one copy per state tensor;
        widened rows (other shapes) one by one. A row whose entry moved
        since its lookup (the serving drain re-admitted or evicted it) is
        left to the device pass."""
        pre: Dict[int, MutableState] = {}

        def hydrate_one(arrs, row, pos, key, batches, entry, rentry):
            ms = self._hydrate(arrs, row, batches, entry,
                               known_size=self._known_size(key, batches))
            if ms is not None and (payload_row(ms, self.layout) == rentry.payload).all():
                pre[pos] = ms

        by_slab: Dict[int, list] = {}
        for r in resolved:
            if r[4].rung == 0:
                by_slab.setdefault(id(r[4].slot.slab), []).append(r)
        for base in by_slab.values():
            for lo in range(0, len(base), 64):
                group = base[lo:lo + 64]
                state, kept = self.resident.gather_current([g[4] for g in group])
                if kept:
                    arrs = _host_state(state)
                    for j, g in enumerate(kept):
                        hydrate_one(arrs, j, *group[g])
        for pos, key, batches, entry, rentry in resolved:
            if rentry.rung != 0:
                state, kept = self.resident.gather_current([rentry])
                if kept:
                    hydrate_one(_host_state(state), 0, pos, key, batches, entry, rentry)
        return pre

    def _known_size(self, key, batches) -> Optional[int]:
        """history_size recovered from a persisted snapshot: the stored
        accounting plus the since-snapshot suffix bytes, O(suffix). None
        (full recomputation) when no snapshot seeded this key or the
        batches involve a continue-as-new chain."""
        info = self._snap_sizes.get(key)
        if info is None:
            return None
        n, size = info
        if n > len(batches) or any(b.new_run_events for b in batches):
            return None
        from ..core.codec import serialize_history
        return size + sum(len(serialize_history([b])) for b in batches[n:])

    @staticmethod
    def _oracle_rebuild(batches, entry) -> MutableState:
        sb = StateBuilder(MutableState(entry))
        for b in batches:
            sb.apply_batch(b)
        ms = sb.new_run_state if sb.new_run_state is not None else sb.ms
        ms.transfer_tasks, ms.timer_tasks, ms.cross_cluster_tasks = [], [], []
        ms.history_size = _rebuilt_history_size(batches, ms.execution_info.run_id)
        return ms

    def _hydrate(self, arrs, i: int, batches: Sequence[HistoryBatch],
                 entry: Optional[DomainEntry],
                 known_size: Optional[int] = None) -> Optional[MutableState]:
        """A ReplayState row (numpy arrays) + host-side event attributes →
        MutableState.

        For a continue-as-new chain the device row ends in the LAST run's
        state, so hydration works on the last run's batches. `known_size`
        stands in for the history-size recomputation when the caller knows
        it."""
        runs: List[List[HistoryBatch]] = [[]]
        for b in batches:
            runs[-1].append(b)
            if b.new_run_events:
                runs.append([HistoryBatch(
                    domain_id=b.domain_id, workflow_id=b.workflow_id,
                    run_id=b.events[-1].get("new_execution_run_id", b.run_id),
                    events=b.new_run_events)])
        last_run = runs[-1]
        by_id: Dict[int, HistoryEvent] = {e.id: e for b in last_run for e in b.events}

        # static/start fields via the oracle on the START BATCH ONLY, the
        # one place all string attributes live; O(1) in history length
        sb = StateBuilder(MutableState(entry))
        try:
            sb.apply_batch(last_run[0])
        except Exception:
            return None
        ms = sb.ms
        ms.transfer_tasks, ms.timer_tasks, ms.cross_cluster_tasks = [], [], []
        ms.history_size = (known_size if known_size is not None and len(runs) == 1
                           else _rebuilt_history_size(last_run, last_run[0].run_id))
        info = ms.execution_info

        # scan-dependent execution scalars from the device
        info.state = int(arrs.state[i])
        info.close_status = int(arrs.close_status[i])
        info.cancel_requested = bool(arrs.cancel_requested[i])
        info.last_first_event_id = int(arrs.last_first_event_id[i])
        info.next_event_id = int(arrs.next_event_id[i])
        info.last_processed_event = int(arrs.last_processed_event[i])
        info.signal_count = int(arrs.signal_count[i])
        info.completion_event_batch_id = int(arrs.completion_event_batch_id[i])
        info.last_event_task_id = int(arrs.last_event_task_id[i])
        info.decision_version = int(arrs.decision_version[i])
        info.decision_schedule_id = int(arrs.decision_schedule_id[i])
        info.decision_started_id = int(arrs.decision_started_id[i])
        info.decision_attempt = int(arrs.decision_attempt[i])
        info.decision_timeout = int(arrs.decision_timeout[i])
        info.decision_scheduled_timestamp = int(arrs.decision_scheduled_ts[i])
        info.decision_started_timestamp = int(arrs.decision_started_ts[i])
        info.decision_original_scheduled_timestamp = int(arrs.decision_original_scheduled_ts[i])
        if info.cancel_requested:
            cancel_ev = next(
                (e for b in last_run for e in reversed(b.events)
                 if e.event_type == EventType.WorkflowExecutionCancelRequested),
                None)
            if cancel_ev is not None:
                info.cancel_request_id = cancel_ev.get("cancel_request_id", "")
        started_ev = by_id.get(info.decision_started_id)
        if started_ev is not None:
            info.decision_request_id = started_ev.get("request_id", "")

        ms.current_version = int(arrs.current_version[i])

        # version histories (current branch only: rebuilds replay ONE
        # lineage; multi-branch grafting is the caller's bookkeeping)
        branch = int(arrs.current_branch[i])
        count = int(arrs.vh_count[i][branch])
        ids = arrs.vh_event_ids[i][branch]
        versions = arrs.vh_versions[i][branch]
        ms.version_histories.histories[0] = VersionHistory(items=[
            VersionHistoryItem(int(ids[k]), int(versions[k])) for k in range(count)])
        ms.version_histories.current_index = 0

        # pending activities
        ms.pending_activity_info_ids.clear()
        ms.pending_activity_id_to_event_id.clear()
        act = arrs.activities
        for k in np.nonzero(act.occ[i])[0]:
            sched_id = int(act.schedule_id[i][k])
            sched_ev = by_id.get(sched_id)
            if sched_ev is None:
                return None
            retry = sched_ev.get("retry_policy")
            started_id = int(act.started_id[i][k])
            astart_ev = by_id.get(started_id)
            ai = ActivityInfo(
                version=int(act.version[i][k]),
                schedule_id=sched_id,
                scheduled_event_batch_id=int(act.batch_id[i][k]),
                scheduled_time=int(act.scheduled_time[i][k]),
                started_id=started_id,
                started_time=int(act.started_time[i][k]),
                activity_id=sched_ev.get("activity_id", ""),
                domain_id=sched_ev.get("domain_id", "") or info.domain_id,
                task_list=sched_ev.get("task_list", ""),
                schedule_to_start_timeout=int(act.sched_to_start[i][k]),
                schedule_to_close_timeout=int(act.sched_to_close[i][k]),
                start_to_close_timeout=int(act.start_to_close[i][k]),
                heartbeat_timeout=int(act.heartbeat[i][k]),
                cancel_requested=bool(act.cancel_requested[i][k]),
                cancel_request_id=int(act.cancel_request_id[i][k]),
                request_id=(astart_ev.get("request_id", "") if astart_ev is not None else ""),
                last_heartbeat_updated_time=int(act.last_heartbeat[i][k]),
                timer_task_status=int(act.timer_status[i][k]),
                attempt=int(act.attempt[i][k]),
                has_retry_policy=bool(act.has_retry[i][k]),
            )
            if ai.has_retry_policy and retry is not None:
                ai.initial_interval = retry.initial_interval_seconds
                ai.backoff_coefficient = retry.backoff_coefficient
                ai.maximum_interval = retry.maximum_interval_seconds
                ai.maximum_attempts = retry.maximum_attempts
                ai.non_retriable_errors = list(retry.non_retriable_error_reasons)
                if retry.expiration_interval_seconds:
                    ai.expiration_time = ai.scheduled_time + (
                        retry.expiration_interval_seconds * 1_000_000_000)
            ms.pending_activity_info_ids[sched_id] = ai
            ms.pending_activity_id_to_event_id[ai.activity_id] = sched_id

        # pending user timers
        ms.pending_timer_info_ids.clear()
        ms.pending_timer_event_id_to_id.clear()
        tmr = arrs.timers
        for k in np.nonzero(tmr.occ[i])[0]:
            started_id = int(tmr.started_id[i][k])
            started = by_id.get(started_id)
            if started is None:
                return None
            ti = TimerInfo(
                version=int(tmr.version[i][k]),
                timer_id=started.get("timer_id", ""),
                started_id=started_id,
                expiry_time=int(tmr.expiry_time[i][k]),
                task_status=int(tmr.task_status[i][k]),
            )
            ms.pending_timer_info_ids[ti.timer_id] = ti
            ms.pending_timer_event_id_to_id[started_id] = ti.timer_id

        # pending children
        ms.pending_child_execution_info_ids.clear()
        ch = arrs.children
        for k in np.nonzero(ch.occ[i])[0]:
            initiated_id = int(ch.initiated_id[i][k])
            init_ev = by_id.get(initiated_id)
            if init_ev is None:
                return None
            started_id = int(ch.started_id[i][k])
            cstart_ev = by_id.get(started_id)
            ms.pending_child_execution_info_ids[initiated_id] = ChildExecutionInfo(
                version=int(ch.version[i][k]),
                initiated_id=initiated_id,
                initiated_event_batch_id=int(ch.batch_id[i][k]),
                started_id=started_id,
                started_workflow_id=init_ev.get("workflow_id", ""),
                started_run_id=(cstart_ev.get("run_id", "") if cstart_ev is not None else ""),
                create_request_id=init_ev.get("create_request_id", ""),
                domain_id=init_ev.get("domain_id", "") or info.domain_id,
                workflow_type_name=init_ev.get("workflow_type", ""),
                parent_close_policy=init_ev.get("parent_close_policy", 0) or 0,
            )

        # pending request-cancels / signals
        ms.pending_request_cancel_info_ids.clear()
        for k in np.nonzero(arrs.cancels.occ[i])[0]:
            initiated_id = int(arrs.cancels.initiated_id[i][k])
            init_ev = by_id.get(initiated_id)
            if init_ev is None:
                return None
            ms.pending_request_cancel_info_ids[initiated_id] = RequestCancelInfo(
                version=int(arrs.cancels.version[i][k]),
                initiated_event_batch_id=int(arrs.cancels.batch_id[i][k]),
                initiated_id=initiated_id,
                cancel_request_id=init_ev.get("cancel_request_id", ""),
            )
        ms.pending_signal_info_ids.clear()
        for k in np.nonzero(arrs.signals.occ[i])[0]:
            initiated_id = int(arrs.signals.initiated_id[i][k])
            init_ev = by_id.get(initiated_id)
            if init_ev is None:
                return None
            ms.pending_signal_info_ids[initiated_id] = SignalInfo(
                version=int(arrs.signals.version[i][k]),
                initiated_event_batch_id=int(arrs.signals.batch_id[i][k]),
                initiated_id=initiated_id,
                signal_request_id=init_ev.get("signal_request_id", ""),
                signal_name=init_ev.get("signal_name", ""),
            )
        return ms
