"""Cross-cluster (NDC/XDC) history replication.

Reference call stack (SURVEY.md §3.5):
- source: replication tasks inserted at transaction close
  (mutable_state_builder.go:3959 insertReplicationTasks), hydrated by
  TaskAckManager.GetTasks (replication/task_ack_manager.go:145);
- target: TaskFetcher polls per source cluster → taskExecutor →
  historyReplicator.ApplyEvents (ndc/history_replicator.go:183) →
  stateBuilder.ApplyEvents (the replay hot loop);
- gaps: the passive side pulls the missing range via the history resender
  (common/ndc/history_resender.go:111);
- poison tasks land in the replication DLQ (replication/dlq_handler.go).

Here the replication transport payload is the framework's binary codec
(core/codec.py) — the same bytes the native packer consumes — so the
passive side can either apply per-workflow through the oracle state
builder (incremental, this module) or bulk-verify/rehydrate thousands of
workflows at once on the card (tpu_engine.py), the "resend-buffered-history
replay" path. The host replicator is the sole authority on legality; the
device standby apply (`_DeviceApplier`) streams what it committed through
the resident pool's grouped from-state launches (kernels G, A and B).
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..core.codec import deserialize_history, serialize_history
from ..core.events import HistoryBatch, HistoryEvent
from ..oracle.mutable_state import DomainEntry, MutableState, ReplayError
from ..oracle.state_builder import StateBuilder
from ..utils import flightrecorder
from ..utils import metrics as m
from . import crashpoints
from .persistence import EntityNotExistsError, Stores

REPLICATION_QUEUE = "replication"
REPLICATION_DLQ = "replication-dlq"

#: kill switch: CADENCE_TPU_REPL_DEVICE=0 restores the host-only standby
#: apply path byte-identically (the pre-device behavior, kept as the
#: parity-audit configuration, same convention as CADENCE_TPU_MIGRATION)
ENABLE_DEVICE_ENV = "CADENCE_TPU_REPL_DEVICE"

#: crashpoint sites on the standby apply pump (engine/crashpoints.py):
#: `repl.apply` fires between reading a task and applying it — recovery
#: must re-deliver (the ack has not advanced), and the replicator's
#: branch-head dedup must swallow the duplicate; `repl.ack` fires after
#: the in-memory ack advanced but before the caller persists it — the
#: durable ack may lag, never lead, the applied state.
SITE_REPL_APPLY = "repl.apply"
SITE_REPL_ACK = "repl.ack"

#: per-domain backpressure: max tasks ONE domain may
#: apply in a single process_once pass. After a partition heals, the
#: ordered queue holds a monolithic flood for the partitioned domain —
#: without a bound, one drain call applies the whole backlog and the
#: host's pump tick (timers, transfer, domain + cross-cluster consumers)
#: starves behind it. 0 disables the bound.
DOMAIN_BUDGET_ENV = "CADENCE_TPU_REPL_DOMAIN_BUDGET"
DEFAULT_DOMAIN_BUDGET = 256


class ReplicationBackpressureShed(Exception):
    """Typed shed: a drain pass stopped early because one domain hit its
    per-pass apply budget. The ack index stops BEFORE the first deferred
    task, so the next pass resumes exactly there — at-least-once order
    preserved, service per tick bounded."""

    def __init__(self, domain_id: str, applied: int, deferred: int) -> None:
        super().__init__(
            f"replication backpressure: domain {domain_id} hit its "
            f"per-pass budget ({applied} applied, {deferred} deferred)")
        self.domain_id = domain_id
        self.applied = applied
        self.deferred = deferred


def _items_until(items: Tuple[Tuple[int, int], ...], event_id: int
                 ) -> Tuple[Tuple[int, int], ...]:
    """Version-history items describing only events <= event_id (the
    DuplicateUntilLCAItem shape applied to wire tuples)."""
    out = []
    for ev, version in items:
        if ev <= event_id:
            out.append((ev, version))
        else:
            out.append((event_id, version))
            break
    return tuple(out)


@dataclass
class ReplicationTask:
    """One history batch crossing the cluster boundary
    (types.ReplicationTask/HistoryTaskV2Attributes analog).

    `version_history_items` is the source branch's version history at send
    time ((event_id, version) pairs) — the NDC branch-selection input
    (ndc/replication_task.go:93 parses the same field)."""

    domain_id: str
    workflow_id: str
    run_id: str
    first_event_id: int
    next_event_id: int
    version: int
    events_blob: bytes  # codec-serialized single batch
    version_history_items: Tuple[Tuple[int, int], ...] = ()


@dataclass
class SyncActivityTask:
    """Transient activity state crossing the cluster boundary
    (types.SyncActivityRequest analog; published on transient activity
    start/retry/heartbeat commits, which write NO history events — without
    it a standby never learns attempt counts or last-failure state,
    reference mutable_state_builder.go:3864 syncActivityTasks)."""

    domain_id: str
    workflow_id: str
    run_id: str
    version: int
    schedule_id: int
    scheduled_time: int
    started_id: int
    started_time: int
    last_heartbeat_time: int
    attempt: int
    last_failure_reason: str = ""
    last_failure_details: bytes = b""
    last_worker_identity: str = ""
    version_history_items: Tuple[Tuple[int, int], ...] = ()


@dataclass
class ShippedSnapshotTask:
    """One checksum-gated device-state snapshot crossing the cluster
    boundary (the warm-failover tier): the source's
    post-append snapshot policy (engine/snapshot.Snapshotter) ships every
    record it writes, so the standby's cold admits and its promotion path
    are `seed_caches` + batch-range suffix replay, never full replay.
    Rides the same replication queue as history batches — ordering with
    the batches it covers is preserved by construction."""

    record: object  # engine/snapshot.SnapshotRecord
    source_cluster: str = ""


class RetryReplicationError(Exception):
    """Gap detected: events [from_event_id, to_event_id) must be resent
    first (types.RetryTaskV2Error analog)."""

    def __init__(self, from_event_id: int, to_event_id: int) -> None:
        super().__init__(f"missing events [{from_event_id}, {to_event_id})")
        self.from_event_id = from_event_id
        self.to_event_id = to_event_id


class ReplicationPublisher:
    """Source side: capture committed batches into the replication queue
    (the insertReplicationTasks seat)."""

    def __init__(self, stores: Stores) -> None:
        self.stores = stores

    def publish(self, domain_id: str, workflow_id: str, run_id: str,
                events: List[HistoryEvent],
                version_history_items: Tuple[Tuple[int, int], ...] = ()) -> None:
        batch = HistoryBatch(domain_id=domain_id, workflow_id=workflow_id,
                             run_id=run_id, events=events)
        task = ReplicationTask(
            domain_id=domain_id, workflow_id=workflow_id, run_id=run_id,
            first_event_id=events[0].id, next_event_id=events[-1].id + 1,
            version=events[-1].version,
            events_blob=serialize_history([batch]),
            version_history_items=version_history_items,
        )
        self.stores.queue.enqueue(REPLICATION_QUEUE, task)

    def publish_sync_activity(self, ms, ai,
                              version_history_items: Tuple[Tuple[int, int], ...]
                              ) -> None:
        """Queue a SyncActivity task for one pending activity's transient
        state (replicationTask TypeSyncActivity hydration)."""
        info = ms.execution_info
        self.stores.queue.enqueue(REPLICATION_QUEUE, SyncActivityTask(
            domain_id=info.domain_id, workflow_id=info.workflow_id,
            run_id=info.run_id, version=ai.version,
            schedule_id=ai.schedule_id, scheduled_time=ai.scheduled_time,
            started_id=ai.started_id, started_time=ai.started_time,
            last_heartbeat_time=ai.last_heartbeat_updated_time,
            attempt=ai.attempt,
            last_failure_reason=ai.last_failure_reason,
            last_failure_details=ai.last_failure_details,
            last_worker_identity=ai.last_worker_identity,
            version_history_items=version_history_items,
        ))

    def publish_snapshot(self, record, source_cluster: str = "") -> None:
        """Ship one post-append SnapshotRecord to every consumer of this
        cluster's replication stream (the Snapshotter's `shipper` hook
        calls this right after a successful local put)."""
        self.stores.queue.enqueue(REPLICATION_QUEUE, ShippedSnapshotTask(
            record=record, source_cluster=source_cluster))

    def read_tasks(self, from_index: int, count: int = 100
                   ) -> List[Tuple[int, ReplicationTask]]:
        """GetReplicationMessages analog (remote pollers track their index)."""
        return self.stores.queue.read(REPLICATION_QUEUE, from_index, count)


class HistoryReplicator:
    """Target side: apply replicated batches to the standby cluster's state.

    Full NDC semantics (ndc/history_replicator.go:183 applyEvents):

    - branch selection: the incoming batch carries the source branch's
      version-history items; the local branch with the deepest common
      ancestor receives it (branch_manager.go:87 prepareVersionHistory);
    - divergence: when the LCA is mid-branch, fork a new branch at the LCA
      (versionHistory DuplicateUntilLCAItem + store ForkHistoryBranch) and
      append there;
    - conflict resolution: events landing on a non-current branch are
      persisted without touching mutable state; when that branch's last
      write version overtakes the current branch's, the mutable state is
      REBUILT by replaying the winning branch (conflict_resolver.go +
      state_rebuilder.go — the bulk analog is the device replay engine) and
      the current pointer switches;
    - run-level arbitration: a replicated run only takes the current-run
      pointer when it wins by version (zombie runs stay persisted but
      non-current, transaction_manager.go createAsZombie analog);
    - contiguity per branch: dedup below the branch head,
      RetryReplicationError gaps for the resender."""

    def __init__(self, stores: Stores, rebuilder=None, notifier=None) -> None:
        self.stores = stores
        #: wakes the target cluster's history long-polls on replicated
        #: progress (events/notifier.go on the standby side)
        self.notifier = notifier
        # conflict-resolution rebuilds run on the accelerator with oracle
        # fallback (engine/rebuild.py DeviceRebuilder; state_rebuilder.go
        # bulk analog); pass the owning cluster's rebuilder so its stats
        # aggregate cluster-wide, or let a standalone replicator own one
        if rebuilder is None:
            from .rebuild import DeviceRebuilder
            rebuilder = DeviceRebuilder()
        self.rebuilder = rebuilder

    def _load(self, task: ReplicationTask) -> Optional[MutableState]:
        """Always read the store: on an active cluster the local engine
        writes the same executions, so a replicator-private cache goes
        stale exactly when conflict resolution matters (the reference
        shares ONE execution cache between engine and replicator with
        per-execution locks; store-direct reads give the same coherence)."""
        key = (task.domain_id, task.workflow_id, task.run_id)
        try:
            return self.stores.execution.get_workflow(*key)
        except EntityNotExistsError:
            return None

    def apply(self, task: ReplicationTask) -> bool:
        """Apply one task. Returns False when the task is stale (dedup);
        raises RetryReplicationError on gaps, ReplayError on corrupt input.

        The batch is applied to a SCRATCH COPY of the loaded state: a
        poison batch that fails mid-apply must leave neither the cache nor
        the store holding partially-applied state (the reference's workflow
        context clears cached mutable state on apply failure)."""
        batches = deserialize_history(task.events_blob, task.domain_id,
                                      task.workflow_id, task.run_id)
        key = (task.domain_id, task.workflow_id, task.run_id)
        ms = self._load(task)
        if ms is None:
            if task.first_event_id != 1:
                # first batch missing: pull history from the start
                raise RetryReplicationError(1, task.first_event_id)
            ms = MutableState(self._domain_entry(task.domain_id))
            return self._apply_to_current(key, ms, task, batches)
        ms = copy.deepcopy(ms)

        # -- branch selection (branch_manager.go:87 prepareVersionHistory) --
        vhs = ms.version_histories
        incoming = self._incoming_items(task)
        branch_index, lca = vhs.find_lca_index_and_item(incoming)
        local = vhs.histories[branch_index]
        appendable = local.is_lca_appendable(lca)
        if appendable:
            expected_next = local.last_item().event_id + 1
        else:
            expected_next = lca.event_id + 1  # a fresh fork would end at LCA
        if task.first_event_id < expected_next:
            return False  # branch already holds these events (dedup)
        if task.first_event_id > expected_next:
            raise RetryReplicationError(expected_next, task.first_event_id)

        fork_spec = None
        if not appendable:
            # divergence: fork at the LCA. Only the SCRATCH version history
            # is touched here; the store branch is created later, after
            # every fallible step, so a failed apply never leaves an orphan
            # store branch that would skew branch indices on retry.
            forked_items = local.duplicate_until_lca(lca)
            fork_spec = (branch_index, lca.event_id)
            vhs.histories.append(forked_items)
            branch_index = len(vhs.histories) - 1

        if branch_index == vhs.current_index:
            return self._apply_to_current(key, ms, task, batches)
        return self._apply_to_noncurrent(key, ms, task, batches, branch_index,
                                         fork_spec)

    def sync_activity(self, task: SyncActivityTask) -> bool:
        """Apply transient activity state to the standby's pending activity
        (ndc/activity_replicator.go:77 SyncActivity + shouldApplySyncActivity
        :210). Returns False when the task is stale/dropped; raises
        RetryReplicationError when local history is missing events."""
        from ..core.enums import WorkflowState
        from ..oracle.mutable_state import VersionHistoryItem
        key = (task.domain_id, task.workflow_id, task.run_id)
        try:
            ms = self.stores.execution.get_workflow(*key)
        except EntityNotExistsError:
            # start event and sync-activity out of order, or run long gone:
            # throw the task away (activity_replicator.go:108-115)
            return False
        if ms.execution_info.state == WorkflowState.Completed:
            return False

        local = ms.version_histories.current()
        incoming = [VersionHistoryItem(e, v)
                    for e, v in task.version_history_items] or \
            [VersionHistoryItem(task.schedule_id, task.version)]
        lca = local.find_lca_item(incoming)
        incoming_vh = type(local)(items=incoming)
        if local.is_lca_appendable(lca) or incoming_vh.is_lca_appendable(lca):
            # case 1 (one history is a prefix of the other): resend when the
            # schedule event is past what this side holds
            if task.schedule_id > lca.event_id:
                raise RetryReplicationError(lca.event_id + 1,
                                            task.schedule_id + 1)
        else:
            # case 2 (diverged): lower incoming version discards; higher
            # incoming version needs the missing events first
            if incoming[-1].version < local.last_item().version:
                return False
            if incoming[-1].version > local.last_item().version:
                raise RetryReplicationError(lca.event_id + 1,
                                            task.schedule_id + 1)

        ms = copy.deepcopy(ms)
        ai = ms.pending_activity_info_ids.get(task.schedule_id)
        if ai is None:
            return False  # activity already finished (out-of-order delivery)
        if ai.version > task.version:
            return False  # failover/reset superseded this attempt
        if ai.version == task.version:
            if ai.attempt > task.attempt:
                return False
            if (ai.attempt == task.attempt
                    and ai.last_heartbeat_updated_time > task.last_heartbeat_time):
                return False

        # ReplicateActivityInfo: overwrite transient fields; reset the timer
        # bits when the attempt advanced so refreshed timers re-create
        if ai.version != task.version or ai.attempt < task.attempt:
            from ..core.enums import TIMER_TASK_STATUS_NONE
            ai.timer_task_status = TIMER_TASK_STATUS_NONE
        ai.version = task.version
        ai.scheduled_time = task.scheduled_time
        ai.started_id = task.started_id
        ai.started_time = task.started_time
        ai.last_heartbeat_updated_time = task.last_heartbeat_time
        ai.attempt = task.attempt
        ai.last_failure_reason = task.last_failure_reason
        ai.last_failure_details = task.last_failure_details
        ai.last_worker_identity = task.last_worker_identity
        self.stores.execution.upsert_workflow(
            ms, set_current=self._wins_current(key, ms))
        return True

    @staticmethod
    def _incoming_items(task: ReplicationTask):
        from ..oracle.mutable_state import VersionHistoryItem
        if task.version_history_items:
            return [VersionHistoryItem(e, v)
                    for e, v in task.version_history_items]
        # legacy tasks without items: a linear history ending at this batch
        return [VersionHistoryItem(task.next_event_id - 1, task.version)]

    def _apply_to_current(self, key, ms: MutableState, task: ReplicationTask,
                          batches: List[HistoryBatch]) -> bool:
        """Current-branch path: replay through the state builder (the hot
        loop the device kernel batches) and persist state + history."""
        sb = StateBuilder(ms)
        for batch in batches:
            sb.apply_batch(batch)
        self._persist(ms, batches)
        return True

    def _apply_to_noncurrent(self, key, ms: MutableState,
                             task: ReplicationTask,
                             batches: List[HistoryBatch],
                             branch_index: int,
                             fork_spec: Optional[tuple]) -> bool:
        """Non-current-branch path: persist events without touching live
        state; then resolve the conflict if this branch now wins by version
        (conflict_resolver.go prepareMutableState).

        Ordering discipline: every fallible step (item bookkeeping, the
        conflict-resolution replay) runs against scratch state / in-memory
        batches FIRST; store mutations (fork, append, pointer switch,
        upsert) happen only once nothing can fail, so a poison batch leaves
        the store untouched and a retry starts clean."""
        vhs = ms.version_histories
        branch = vhs.histories[branch_index]
        for batch in batches:
            for event in batch.events:
                branch.add_or_update_item(event.id, event.version)

        # branch contents in memory: (forked prefix | persisted branch) +
        # the incoming batches — needed fallibly for the rebuild below
        rebuilt = None
        if branch.last_item().version > vhs.current().last_item().version:
            if fork_spec is not None:
                source_branch, fork_event_id = fork_spec
                base = [
                    HistoryBatch(domain_id=key[0], workflow_id=key[1],
                                 run_id=key[2], events=b)
                    for b in self._forked_batches(key, source_branch,
                                                  fork_event_id)
                ]
            else:
                base = self.stores.history.as_history_batches(
                    *key, branch=branch_index)
            # the winning branch's full lineage replays ON DEVICE; the
            # hydrated state is payload-checked against the kernel's own
            # canonical row, with oracle fallback counted by the rebuilder
            rebuilt = self.rebuilder.rebuild_one(
                base + list(batches), self._domain_entry(key[0]))

        # -- store mutations: nothing below raises on valid input ----------
        if fork_spec is not None:
            source_branch, fork_event_id = fork_spec
            store_index = self.stores.history.fork_branch(
                *key, source_branch=source_branch,
                fork_event_id=fork_event_id)
            if store_index != branch_index:
                raise ReplayError(
                    f"branch index skew: store {store_index} != "
                    f"version-history {branch_index}")
        for batch in batches:
            self.stores.history.append_batch(*key, events=batch.events,
                                             branch=branch_index)
        if rebuilt is not None:
            # conflict resolution: winning branch becomes current
            # (state_rebuilder.go full replay; bulk analog: TPUReplayEngine)
            vhs.histories[branch_index] = rebuilt.version_histories.current()
            rebuilt.version_histories = vhs
            vhs.current_index = branch_index
            self.stores.history.set_current_branch(*key, branch=branch_index)
            rebuilt.transfer_tasks, rebuilt.timer_tasks = [], []
            rebuilt.cross_cluster_tasks = []
            ms = rebuilt
        self.stores.execution.upsert_workflow(
            ms, set_current=self._wins_current(key, ms))
        self._notify(key, ms)
        return True

    def _notify(self, key, ms: MutableState) -> None:
        from ..core.enums import WorkflowState
        if self.notifier is not None:
            self.notifier.notify(key, ms.execution_info.next_event_id,
                                 ms.execution_info.state == WorkflowState.Completed)

    def _forked_batches(self, key, source_branch: int, fork_event_id: int):
        """The fork's prefix batches (source branch up to the fork event),
        without materializing the fork in the store."""
        out = []
        for b in self.stores.history.read_batches(*key, branch=source_branch):
            if b[-1].id <= fork_event_id:
                out.append(b)
            else:
                partial = [e for e in b if e.id <= fork_event_id]
                if partial:
                    out.append(partial)
                break
        return out

    def _domain_entry(self, domain_id: str) -> DomainEntry:
        try:
            d = self.stores.domain.by_id(domain_id)
            return DomainEntry(domain_id=d.domain_id, name=d.name,
                               is_active=False,  # passive side
                               retention_days=d.retention_days)
        except EntityNotExistsError:
            return DomainEntry(domain_id=domain_id, is_active=False)

    def _persist(self, ms: MutableState, batches: List[HistoryBatch]) -> None:
        """UpdateWorkflowExecutionAsPassive analog: append history + upsert
        the snapshot through the store API. Tasks generated during passive
        apply are DISCARDED: a standby does not dispatch work, and a
        promoted standby regenerates every task from mutable state via the
        task refresher (mutable_state_task_refresher.go:77 analog in
        engine/task_refresher.py) — persisting them here would flush stale
        ghosts into the shard queues on the first post-failover commit."""
        info = ms.execution_info
        key = (info.domain_id, info.workflow_id, info.run_id)
        branch = ms.version_histories.current_index
        for batch in batches:
            self.stores.history.append_batch(*key, events=batch.events,
                                             branch=branch)
        ms.transfer_tasks, ms.timer_tasks, ms.cross_cluster_tasks = [], [], []
        self.stores.execution.upsert_workflow(
            ms, set_current=self._wins_current(key, ms))
        self._notify(key, ms)

    def _wins_current(self, key, ms: MutableState) -> bool:
        """Run-level arbitration (transaction_manager.go create-as-current
        vs create-as-zombie): a replicated run takes the current-run pointer
        unless a DIFFERENT open run with a higher last-write version already
        holds it."""
        from ..core.enums import WorkflowState
        domain_id, workflow_id, run_id = key
        try:
            cur_run = self.stores.execution.get_current_run_id(
                domain_id, workflow_id)
        except EntityNotExistsError:
            return True
        if cur_run == run_id:
            return True
        try:
            cur_ms = self.stores.execution.get_workflow(
                domain_id, workflow_id, cur_run)
        except EntityNotExistsError:
            return True
        if cur_ms.execution_info.state == WorkflowState.Completed:
            # a closed current run yields to an open incoming run
            return ms.execution_info.state != WorkflowState.Completed \
                or ms.get_last_write_version() >= cur_ms.get_last_write_version()
        return ms.get_last_write_version() > cur_ms.get_last_write_version()


@dataclass
class DLQEntry:
    task: ReplicationTask
    error: str


class _DeviceApplier:
    """Standby device twin of the host apply pump: after the
    host `HistoryReplicator` — sole authority on legality — commits a
    drain's batches, the touched histories stream through the resident
    tier's grouped from-state launches (`replay_append_report`, the same
    launches the serving flush and migration hydration ride: kernel G
    gathers each group, kernel A replays the suffix from the carried
    state, kernel B reduces it), so the standby's card-resident state
    stays hot at the bulk-ingest rate.

    Per-apply parity gate: every finished row's pinned payload is
    byte-compared against the oracle's freshly-persisted state
    (`payload_row`); a mismatch is counted and the row invalidated —
    divergence is NEVER served. Keys the device cannot take cheaply
    (multi-branch NDC conflicts, no resident entry and no valid shipped
    snapshot) stay host-only and are counted cold."""

    def __init__(self, tpu, registry=None) -> None:
        self.tpu = tpu
        self.metrics = registry if registry is not None else m.DEFAULT_REGISTRY

    def enabled(self) -> bool:
        if self.tpu is None:
            return False
        if os.environ.get(ENABLE_DEVICE_ENV, "1") in ("0", "false", "off"):
            return False
        from . import resident as resident_mod
        return resident_mod.enabled()

    def apply_keys(self, keys) -> int:
        """Batch-hydrate/advance `keys` (the drain's applied histories) on
        the device; returns how many rows finished parity-clean."""
        import numpy as np

        from ..core.checksum import STICKY_ROW_INDEX, payload_row
        from ..core.enums import WorkflowState
        from . import snapshot as snapshot_mod
        from .cache import ContentAddress, batch_crc

        scope = self.metrics.scope(m.SCOPE_REPLICATION)
        tpu = self.tpu
        # the engine's mesh wires the pool's shard slices before the first
        # lookup or admit (a shipped snapshot admits onto the owning device)
        tpu.mesh
        stores, resident = tpu.stores, tpu.resident
        pack_cache, layout = tpu.pack_cache, tpu.layout
        hs = stores.history
        suffix: List[tuple] = []
        anchors: Dict[tuple, int] = {}
        expected: Dict[tuple, tuple] = {}
        targets: Dict[tuple, ContentAddress] = {}
        finished: List[tuple] = []
        # one pool call: the shipped snapshot rows admitted here reach the
        # card together when it ends (one copy per state tensor and one
        # kernel-G write), before the suffix replay gathers them
        with resident.batch():
            for key in keys:
                try:
                    ms = stores.execution.get_workflow(*key)
                except Exception:
                    continue
                if int(ms.execution_info.state) == int(WorkflowState.Completed):
                    # closed runs take no more transactions: nothing to keep hot
                    resident.invalidate(key)
                    continue
                try:
                    if hs.branch_count(*key) > 1 \
                            or hs.get_current_branch(*key) != 0:
                        # NDC conflict territory stays host-only; a pinned row
                        # from before the branch switch must not linger
                        resident.invalidate(key)
                        scope.inc(m.M_REPL_DEVICE_COLD)
                        continue
                    total = hs.batch_count(*key)
                except Exception:
                    scope.inc(m.M_REPL_DEVICE_COLD)
                    continue
                if total == 0:
                    continue
                entry = resident.entry_for(key)
                rec = None
                if entry is None and snapshot_mod.enabled():
                    try:
                        rec = stores.snapshot.get(key)
                    except Exception:
                        rec = None
                    if rec is not None and not snapshot_mod.validate_record(
                            rec, layout, self.metrics):
                        rec = None
                if entry is None and rec is None:
                    scope.inc(m.M_REPL_DEVICE_COLD)
                    continue
                from_addr = entry.address if entry is not None else rec.address
                if not 0 < from_addr.batch_count <= total:
                    resident.invalidate(key)
                    scope.inc(m.M_REPL_DEVICE_STALE)
                    continue
                try:
                    part = hs.as_history_batches_range(
                        *key, from_batch=from_addr.batch_count - 1)
                except Exception:
                    scope.inc(m.M_REPL_DEVICE_COLD)
                    continue
                if not part or batch_crc(part[0]) != from_addr.last_batch_crc:
                    # tail overwrite between the pin point and this apply
                    resident.invalidate(key)
                    scope.inc(m.M_REPL_DEVICE_STALE)
                    continue
                if entry is None:
                    if not snapshot_mod.seed_caches(rec, resident, pack_cache,
                                                    layout, self.metrics):
                        scope.inc(m.M_REPL_DEVICE_COLD)
                        continue
                    entry = resident.entry_for(key)
                    if entry is None:
                        scope.inc(m.M_REPL_DEVICE_COLD)
                        continue
                row = payload_row(ms, layout)
                row[STICKY_ROW_INDEX] = 0
                expected[key] = (row, int(ms.version_histories.current_index),
                                 int(ms.execution_info.next_event_id))
                anchors[key] = int(part[-1].events[-1].id)
                new_addr = ContentAddress(total, batch_crc(part[-1]))
                targets[key] = new_addr
                if from_addr.batch_count == total:
                    finished.append(key)  # already at tip (snapshot == tip)
                    continue
                rows = pack_cache.encode_append(key, from_addr, part[1:],
                                                new_addr)
                if rows is None:
                    # interner seed evicted out from under us: leave the key
                    # to the promotion path's full-read admit
                    resident.invalidate(key)
                    scope.inc(m.M_REPL_DEVICE_COLD)
                    continue
                suffix.append((key, entry, (rows, new_addr)))
        if suffix:
            results, append_report = tpu.resident.replay_append_report(
                suffix,
                encode_suffix=lambda _k, token, _f: token[0],
                address_of=lambda token: token[1])
            scope.inc(m.M_REPL_DEVICE_SUFFIX_EVENTS,
                      append_report.events_appended)
            for (key, _entry, _token), res in zip(suffix, results):
                if not res.ok:
                    scope.inc(m.M_REPL_DEVICE_COLD)
                    continue
                finished.append(key)
        ok = 0
        for key in finished:
            entry = tpu.resident.entry_for(key)
            if entry is None:
                scope.inc(m.M_REPL_DEVICE_COLD)
                continue
            row, branch, next_id = expected[key]
            if anchors[key] + 1 != next_id \
                    or entry.address != targets.get(key):
                # a foreign commit moved the entry mid-pass (the live
                # serving tier's own gated parity covered that move)
                scope.inc(m.M_REPL_DEVICE_APPLIED)
                scope.inc(m.M_REPL_DEVICE_UNSTABLE)
                ok += 1
                continue
            payload = np.asarray(entry.payload, dtype=np.int64)
            if (payload == row).all() and int(entry.branch) == branch:
                scope.inc(m.M_REPL_DEVICE_APPLIED)
                ok += 1
            else:
                # never serve wrong state: drop and count — gated at zero
                # by the replication tests
                tpu.resident.invalidate(key)
                scope.inc(m.M_REPL_DEVICE_DIVERGENCE)
                flightrecorder.emit("replication-divergence",
                                    domain=key[0], workflow=key[1],
                                    run=key[2])
        return ok


class ReplicationTaskProcessor:
    """Target-side pump: polls the source queue, applies tasks, resolves
    gaps via the resender, quarantines poison tasks in the DLQ
    (replication/task_processor.go + task_fetcher.go).

    With a `tpu` engine wired (the standby's TPUReplayEngine), each drain
    additionally streams its applied histories through the device twin
    (`_DeviceApplier`) and installs shipped snapshots — both strictly
    downstream of the host replicator's legality decisions."""

    def __init__(self, replicator: HistoryReplicator, source: ReplicationPublisher,
                 target_stores: Stores,
                 source_history_reader: Optional[Callable] = None,
                 tpu=None) -> None:
        self.replicator = replicator
        self.source = source
        self.stores = target_stores
        #: SendSingleWorkflowHistory analog: (domain, wf, run, from_id, to_id)
        #: → batches from the source cluster's history store
        self.source_history_reader = source_history_reader
        self.ack_index = 0
        self.applied = 0
        self.deduped = 0
        self.resends = 0
        self.snapshots_installed = 0
        #: per-pass per-domain apply bound (see DOMAIN_BUDGET_ENV); the
        #: env default keeps subprocess hosts tunable with zero plumbing
        try:
            self.domain_budget = int(
                os.environ.get(DOMAIN_BUDGET_ENV, DEFAULT_DOMAIN_BUDGET))
        except ValueError:
            self.domain_budget = DEFAULT_DOMAIN_BUDGET
        self.sheds = 0
        #: the most recent typed shed (None when the last pass ran clean)
        self.last_shed: Optional[ReplicationBackpressureShed] = None
        self._metrics = m.DEFAULT_REGISTRY
        self.device = _DeviceApplier(tpu, self._metrics)

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, registry) -> None:
        self._metrics = registry
        self.device.metrics = registry

    def _apply_task(self, task) -> bool:
        """Dispatch by task type (replication/task_executor.go:80 execute)."""
        if isinstance(task, SyncActivityTask):
            return self.replicator.sync_activity(task)
        return self.replicator.apply(task)

    def process_once(self, batch_size: int = 100,
                     raise_on_shed: bool = False) -> int:
        scope = self.metrics.scope(m.SCOPE_REPLICATION)
        tasks = self.source.read_tasks(self.ack_index, batch_size)
        touched: List[tuple] = []
        seen = set()
        per_domain: Dict[str, int] = {}
        self.last_shed = None
        processed = 0
        for pos, (index, task) in enumerate(tasks):
            domain_id = getattr(task, "domain_id", None)
            if (self.domain_budget > 0 and domain_id is not None
                    and per_domain.get(domain_id, 0) >= self.domain_budget):
                # typed shed: stop BEFORE this task (ack stays behind it,
                # so the ordered queue redelivers next pass) — a heal
                # flood on one domain yields the tick back to every other
                # consumer instead of monopolizing it
                deferred = len(tasks) - pos
                self.sheds += 1
                self.last_shed = ReplicationBackpressureShed(
                    domain_id, per_domain[domain_id], deferred)
                scope.inc(m.M_REPL_BP_SHED)
                scope.inc(m.M_REPL_BP_DEFERRED, deferred)
                flightrecorder.emit("repl-backpressure-shed",
                                    domain=domain_id,
                                    applied=per_domain[domain_id],
                                    deferred=deferred)
                break
            if domain_id is not None:
                per_domain[domain_id] = per_domain.get(domain_id, 0) + 1
            crashpoints.fire(SITE_REPL_APPLY)
            if isinstance(task, ShippedSnapshotTask):
                self._install_shipped(task, scope)
                self.ack_index = index + 1
                processed += 1
                crashpoints.fire(SITE_REPL_ACK)
                continue
            try:
                if self._apply_task(task):
                    self.applied += 1
                    scope.inc(m.M_REPL_APPLIED)
                    key = (task.domain_id, task.workflow_id, task.run_id)
                    if isinstance(task, ReplicationTask) and key not in seen:
                        seen.add(key)
                        touched.append(key)
                else:
                    self.deduped += 1
                    scope.inc(m.M_REPL_DEDUPED)
            except RetryReplicationError as gap:
                scope.inc(m.M_REPL_RESENT)
                self._resend(task, gap)
            except ReplayError as err:
                self._quarantine(task, str(err))
            self.ack_index = index + 1
            processed += 1
            crashpoints.fire(SITE_REPL_ACK)
        if touched and self.device.enabled():
            self.device.apply_keys(touched)
        if self.last_shed is not None and raise_on_shed:
            raise self.last_shed
        return processed

    def _install_shipped(self, task: ShippedSnapshotTask, scope) -> None:
        """Install one shipped snapshot into the standby's store: torn
        (blob CRC), foreign (format/layout signature), and stale (address
        no longer prefixes the local history) records are detected,
        counted, and ignored — never installed."""
        import zlib

        from . import snapshot as snapshot_mod
        from .cache import batch_crc

        rec = task.record
        scope.inc(m.M_REPL_SNAP_SHIPPED)
        if not snapshot_mod.enabled():
            return
        try:
            if zlib.crc32(rec.state_blob) != rec.blob_crc:
                scope.inc(m.M_REPL_SNAP_IGNORED_TORN)
                return
            if rec.version != snapshot_mod.SNAPSHOT_VERSION:
                scope.inc(m.M_REPL_SNAP_IGNORED_FOREIGN)
                return
            tpu = self.device.tpu
            if tpu is not None and tuple(rec.layout) != \
                    snapshot_mod.layout_signature(tpu.layout):
                scope.inc(m.M_REPL_SNAP_IGNORED_FOREIGN)
                return
            # stale check against whatever history the standby holds: a
            # record covering batches we already store must match their
            # bytes (the boundary-batch CRC discipline); a record AHEAD of
            # local history installs fine — the batches it covers are in
            # flight behind it on the same queue
            hs = self.stores.history
            try:
                total = hs.batch_count(*rec.key)
            except Exception:
                total = 0
            if 0 < rec.batch_count <= total:
                part = hs.as_history_batches_range(
                    *rec.key, from_batch=rec.batch_count - 1)
                if not part or batch_crc(part[0]) != rec.last_batch_crc:
                    scope.inc(m.M_REPL_SNAP_IGNORED_STALE)
                    return
            self.stores.snapshot.put(rec)
        except Exception:
            scope.inc(m.M_REPL_SNAP_IGNORED_TORN)
            return
        self.snapshots_installed += 1
        scope.inc(m.M_REPL_SNAP_INSTALLED)

    def _quarantine(self, task, error: str) -> None:
        """One DLQ entry: counted, depth-gauged, and flight-recorded (the
        DLQ is the operator's poison-task surface — invisible entries are
        how replication silently wedges)."""
        scope = self.metrics.scope(m.SCOPE_REPLICATION)
        scope.inc(m.M_REPL_DLQ)
        self.stores.queue.enqueue(REPLICATION_DLQ,
                                  DLQEntry(task=task, error=error))
        depth = self.stores.queue.size(REPLICATION_DLQ)
        scope.gauge(m.M_REPL_DLQ_DEPTH, float(depth))
        flightrecorder.emit("replication-dlq",
                            domain=getattr(task, "domain_id", ""),
                            workflow=getattr(task, "workflow_id", ""),
                            run=getattr(task, "run_id", ""),
                            error=error[:200], depth=depth)

    def _resend(self, task: ReplicationTask, gap: RetryReplicationError) -> None:
        """Pull the missing range and re-apply (history_resender.go:111).

        Errors inside the resend get the same routing as the main loop:
        ReplayError (or a still-unresolved gap) quarantines the original
        task in the DLQ instead of crashing the pump and wedging the ack
        index on the same task forever."""
        if self.source_history_reader is None:
            self._quarantine(task, str(gap))
            return
        self.resends += 1
        try:
            missing = self.source_history_reader(
                task.domain_id, task.workflow_id, task.run_id,
                gap.from_event_id, gap.to_event_id)
            for batch in missing:
                last_id = batch.events[-1].id
                self.replicator.apply(ReplicationTask(
                    domain_id=task.domain_id, workflow_id=task.workflow_id,
                    run_id=task.run_id, first_event_id=batch.events[0].id,
                    next_event_id=last_id + 1,
                    version=batch.events[-1].version,
                    events_blob=serialize_history([batch]),
                    # the missing range is a prefix of the original task's
                    # branch: its items capped at this batch's last event
                    # keep NDC branch selection working on divergent runs
                    version_history_items=_items_until(
                        task.version_history_items, last_id),
                ))
            applied = self._apply_task(task)
        except (RetryReplicationError, ReplayError) as err:
            self._quarantine(task, str(err))
            return
        if applied:
            self.applied += 1
        else:
            self.deduped += 1

    # -- DLQ surface (replication/dlq_handler.go read/purge/merge) ---------

    def read_dlq(self) -> List[DLQEntry]:
        return [e for _, e in self.stores.queue.read(REPLICATION_DLQ, 0, 10_000)]

    def dlq_summary(self) -> Dict[str, object]:
        """The DLQ rollup: depth, the oldest quarantined task, and
        error classes (the text up to the first ':' — exception-ish
        prefixes group naturally). Also refreshes the depth gauge, so a
        scrape after an operator look never reads a stale depth."""
        entries = self.read_dlq()
        scope = self.metrics.scope(m.SCOPE_REPLICATION)
        scope.gauge(m.M_REPL_DLQ_DEPTH, float(len(entries)))
        classes: Dict[str, int] = {}
        for e in entries:
            cls = (e.error or "unknown").split(":", 1)[0].strip()[:80]
            classes[cls] = classes.get(cls, 0) + 1
        oldest = None
        if entries:
            t = entries[0].task
            oldest = {"domain_id": getattr(t, "domain_id", ""),
                      "workflow_id": getattr(t, "workflow_id", ""),
                      "run_id": getattr(t, "run_id", ""),
                      "first_event_id": getattr(t, "first_event_id", 0),
                      "error": entries[0].error[:200]}
        return {"depth": len(entries), "oldest": oldest,
                "error_classes": classes}

    def redrive_dlq(self) -> Dict[str, int]:
        """The DLQ redrive arm: drain the DLQ and re-apply every
        entry THROUGH THE RESENDER (gaps pull their missing range exactly
        like the live pump), re-quarantining what still fails — a redrive
        can only shrink the DLQ or keep it, never wedge the pump."""
        scope = self.metrics.scope(m.SCOPE_REPLICATION)
        entries = self.read_dlq()
        self.stores.queue.purge(REPLICATION_DLQ)
        for entry in entries:
            try:
                self._apply_task(entry.task)
            except RetryReplicationError as gap:
                self._resend(entry.task, gap)
            except ReplayError as err:
                self._quarantine(entry.task, str(err))
        remaining = self.stores.queue.size(REPLICATION_DLQ)
        scope.gauge(m.M_REPL_DLQ_DEPTH, float(remaining))
        redriven = len(entries) - remaining
        scope.inc(m.M_REPL_REDRIVEN, redriven)
        return {"read": len(entries), "redriven": redriven,
                "requeued": remaining}

    def merge_dlq(self) -> int:
        """Retry everything in the DLQ; returns how many now applied."""
        entries = self.read_dlq()
        ok = 0
        for entry in entries:
            try:
                if self._apply_task(entry.task):
                    ok += 1
            except (RetryReplicationError, ReplayError):
                pass
        return ok
