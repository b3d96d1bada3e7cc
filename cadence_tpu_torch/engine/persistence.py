"""Persistence layer: stores + conditional-update fencing.

The reference's persistence stack (common/persistence/dataStoreInterfaces.go
ExecutionStore/HistoryStore/TaskStore/ShardStore/DomainStore/QueueStore, with
nosql/sql backends) reduced to its semantic contract:

- every shard write is fenced by the owner's range ID
  (shard/context.go:586-700): a stale owner's writes fail with
  ShardOwnershipLostError and it must self-close;
- workflow-execution updates are conditional on the next-event-id read in
  the same transaction (mutable_state_builder.go:129-130 nextEventIDInDB),
  failing with ConditionFailedError on concurrent modification;
- per workflow ID there is one current run (executionManager.go current
  execution record);
- history is an append-only sequence of event batches per run
  (historyManager.go tree/branch model; single branch here — the NDC
  branch tree arrives with the replication layer).

Durability: every store accepts an optional write-ahead log
(engine/durability.py DurableLog, which comes to the port with the host
control plane; until then no log is attached and nothing is logged). Mutations append one JSONL record;
recovery replays the log into fresh stores and REBUILDS mutable states
from history (event sourcing — the snapshot store is derivable), with the
replay engine bulk-verifying the rebuilt states (the reference's
recovery path is stateRebuilder per workflow, state_rebuilder.go:102).
All stores are thread-safe.

This is the JAX package's engine/persistence.py, copied: it holds no JAX.
The one addition is `VisibilityStore.device`, where the device visibility
twin keeps its columns (None: the card).
"""
from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ..core.events import HistoryBatch, HistoryEvent
from ..oracle.mutable_state import MutableState
from . import crashpoints


class ConditionFailedError(Exception):
    """Conditional update lost (persistence ConditionFailedError)."""


class ShardOwnershipLostError(Exception):
    """Range-ID fence rejected the write (persistence ShardOwnershipLostError)."""


class WorkflowAlreadyStartedError(Exception):
    """Current run exists and is open (WorkflowExecutionAlreadyStartedError)."""


class EntityNotExistsError(Exception):
    pass


# ---------------------------------------------------------------------------
# Shard store (ShardManager, dataManagerInterfaces.go:1688; ShardInfo :275)
# ---------------------------------------------------------------------------


@dataclass
class ShardInfo:
    shard_id: int
    owner: str = ""
    range_id: int = 0
    transfer_ack_level: int = 0
    timer_ack_level: int = 0  # nanos
    replication_ack_level: int = 0
    stolen_since_renew: int = 0
    #: multi-level transfer processing-queue states (queue/interface.go
    #: ProcessingQueueState persisted in shard info): entries of
    #: [level, ack_level, domains|None, excluded_domains] — a new owner
    #: resumes each level from ITS ack, not one global floor
    transfer_queue_states: List[list] = field(default_factory=list)


class ShardStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._shards: Dict[int, ShardInfo] = {}
        self._wal = None

    def get_or_create(self, shard_id: int) -> ShardInfo:
        with self._lock:
            if shard_id not in self._shards:
                self._shards[shard_id] = ShardInfo(shard_id=shard_id)
            s = self._shards[shard_id]
            return ShardInfo(**vars(s))

    def update(self, info: ShardInfo, expected_range_id: int) -> None:
        """Conditional on the previous range ID (renewRangeLocked fencing,
        shard/context.go:1068)."""
        with self._lock:
            cur = self._shards.get(info.shard_id)
            if cur is None or cur.range_id != expected_range_id:
                raise ShardOwnershipLostError(
                    f"shard {info.shard_id}: expected range {expected_range_id}, "
                    f"have {cur.range_id if cur else None}"
                )
            self._shards[info.shard_id] = ShardInfo(**vars(info))
            if self._wal is not None:
                from .durability import shard_record
                self._wal.append(shard_record(info))

    def restore(self, info: ShardInfo) -> None:
        """Recovery: install a shard record without fencing checks."""
        with self._lock:
            self._shards[info.shard_id] = ShardInfo(**vars(info))


# ---------------------------------------------------------------------------
# History store (HistoryManager, dataManagerInterfaces.go:1764; append
# AppendHistoryNodes nosqlHistoryStore.go:76, read ReadHistoryBranchByBatch)
# ---------------------------------------------------------------------------


class HistoryStore:
    """Branched event-batch store (historyManager.go tree/branch model).

    Each run holds a list of branches; branch 0 is created on first append.
    A branch is a strictly-contiguous list of event batches. `fork_branch`
    is the ForkHistoryBranch analog (nosqlHistoryStore.go:238): the new
    branch copies the source up to the fork event (splitting a batch when
    the fork lands mid-batch). The per-run current-branch pointer tracks
    NDC conflict resolution (which branch the mutable state follows);
    callers that pass branch=None read/append the current branch."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: (domain_id, workflow_id, run_id) -> list of branches, each a
        #: list of event batches
        self._branches: Dict[Tuple[str, str, str], List[List[List[HistoryEvent]]]] = {}
        self._current: Dict[Tuple[str, str, str], int] = {}
        self._wal = None
        #: SnapshotStore back-reference (Stores wires it): history
        #: mutations that rewrite bytes under a snapshot's content
        #: address — tail overwrite at/before the snapshot point, NDC
        #: branch switch, run deletion — drop the snapshot HERE, the one
        #: place every writer funnels through. Recovery replays these
        #: same records in the same order, so the derived invalidation
        #: converges without tombstone records.
        self._snapshots = None
        #: lazily-extended per-batch serialized sizes ((key, branch) ->
        #: [bytes per batch], always a valid prefix of the branch):
        #: serialized_size() extends it O(appended) on the append-only
        #: fast path and any overwrite drops it — so the snapshot writer
        #: reads the mutable-state history_size without re-serializing
        #: the whole branch per record
        self._size_cache: Dict[Tuple[Tuple[str, str, str], int],
                               List[int]] = {}

    def append_batch(self, domain_id: str, workflow_id: str, run_id: str,
                     events: List[HistoryEvent],
                     branch: Optional[int] = None,
                     blob: Optional[bytes] = None) -> None:
        """Append a batch; contiguity enforced per branch. `blob` is the
        caller's already-serialized bytes for exactly these events (the
        commit path pays serialize_history once, for history-size
        accounting, and the WAL record reuses it).

        Re-appending at an id the branch already holds OVERWRITES the tail
        from that id (Cassandra history-node overwrite semantics,
        nosqlHistoryStore.go AppendHistoryNodes): a transaction that
        appended its events but failed before its state-update commit
        point retries by rewriting the same ids — the torn tail must not
        wedge the branch. A gap (first id beyond the tail) still fails."""
        if not events:
            raise ValueError("empty history batch")
        crashpoints.fire("store.history.append_batch")
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            branches = self._branches.setdefault(key, [[]])
            index = self._current.get(key, 0) if branch is None else branch
            if index >= len(branches):
                raise EntityNotExistsError(f"no branch {index} for {key}")
            target = branches[index]
            first = events[0].id
            if target:
                expected = target[-1][-1].id + 1
                if first > expected:
                    raise ConditionFailedError(
                        f"history append out of order: got first id "
                        f"{first}, expected {expected}"
                    )
                if first < expected:
                    # overwrite: drop the tail from `first` on
                    truncated_last = False
                    while target and target[-1][0].id >= first:
                        target.pop()
                    if target and target[-1][-1].id >= first:
                        kept = [e for e in target[-1] if e.id < first]
                        if kept:
                            target[-1] = kept
                            truncated_last = True
                        else:
                            target.pop()
                    if target and target[-1][-1].id + 1 != first:
                        raise ConditionFailedError(
                            f"history overwrite leaves a gap before {first}")
                    self._size_cache.pop((key, index), None)
                    if self._snapshots is not None \
                            and (branch is None or index ==
                                 self._current.get(key, 0)):
                        # a snapshot covering any rewritten batch is
                        # dead (its tail CRC no longer matches stored
                        # bytes); one strictly before the rewrite point
                        # remains a valid prefix and survives. A
                        # mid-batch truncation rewrote the LAST KEPT
                        # batch too, so the boundary moves back one.
                        self._snapshots.invalidate_overwrite(
                            key, len(target) - (1 if truncated_last
                                                else 0))
            target.append(list(events))
            if self._wal is not None:
                from .durability import history_record, history_record_from_blob
                self._wal.append(
                    history_record_from_blob(domain_id, workflow_id, run_id,
                                             index, blob)
                    if blob is not None else
                    history_record(domain_id, workflow_id, run_id, index,
                                   events))

    def fork_branch(self, domain_id: str, workflow_id: str, run_id: str,
                    source_branch: int, fork_event_id: int) -> int:
        """New branch = source's batches up to and including fork_event_id;
        returns the new branch index (ForkHistoryBranch analog)."""
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            branches = self._branches.get(key)
            if branches is None or source_branch >= len(branches):
                raise EntityNotExistsError(f"no branch {source_branch} for {key}")
            forked: List[List[HistoryEvent]] = []
            for batch in branches[source_branch]:
                if batch[-1].id <= fork_event_id:
                    forked.append(list(batch))
                else:
                    partial = [e for e in batch if e.id <= fork_event_id]
                    if partial:
                        forked.append(partial)
                    break
            branches.append(forked)
            if self._wal is not None:
                from .durability import fork_record
                self._wal.append(fork_record(domain_id, workflow_id, run_id,
                                             source_branch, fork_event_id))
            return len(branches) - 1

    def set_current_branch(self, domain_id: str, workflow_id: str,
                           run_id: str, branch: int) -> None:
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            switched = self._current.get(key, 0) != branch
            self._current[key] = branch
            if switched and self._snapshots is not None:
                # NDC branch switch: the snapshot's lineage is no longer
                # what consumers replay (same rule as the resident cache)
                self._snapshots.invalidate_branch_switch(key)
            if self._wal is not None:
                from .durability import current_branch_record
                self._wal.append(current_branch_record(
                    domain_id, workflow_id, run_id, branch))

    def get_current_branch(self, domain_id: str, workflow_id: str,
                           run_id: str) -> int:
        with self._lock:
            return self._current.get((domain_id, workflow_id, run_id), 0)

    def delete_run(self, domain_id: str, workflow_id: str, run_id: str) -> bool:
        """Retention deletion (DeleteHistoryBranch analog): drop every
        branch of a run; tombstoned in the WAL so recovery doesn't
        resurrect it."""
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            existed = self._branches.pop(key, None) is not None
            self._current.pop(key, None)
            for cache_key in [k for k in self._size_cache if k[0] == key]:
                del self._size_cache[cache_key]
            if self._snapshots is not None:
                self._snapshots.drop(key)
            if existed and self._wal is not None:
                from .durability import delete_run_record
                self._wal.append(delete_run_record(domain_id, workflow_id,
                                                   run_id))
            return existed

    def list_runs(self) -> List[Tuple[str, str, str]]:
        with self._lock:
            return list(self._branches.keys())

    def branch_count(self, domain_id: str, workflow_id: str, run_id: str) -> int:
        with self._lock:
            branches = self._branches.get((domain_id, workflow_id, run_id))
            return 0 if branches is None else len(branches)

    def read_batches(self, domain_id: str, workflow_id: str, run_id: str,
                     branch: Optional[int] = None) -> List[List[HistoryEvent]]:
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            branches = self._branches.get(key)
            if branches is None:
                raise EntityNotExistsError(f"no history for {workflow_id}/{run_id}")
            index = self._current.get(key, 0) if branch is None else branch
            if index >= len(branches):
                raise EntityNotExistsError(f"no branch {index} for {key}")
            return [list(b) for b in branches[index]]

    def read_events(self, domain_id: str, workflow_id: str, run_id: str,
                    branch: Optional[int] = None) -> List[HistoryEvent]:
        return [e for b in self.read_batches(domain_id, workflow_id, run_id,
                                             branch)
                for e in b]

    def serialized_size(self, domain_id: str, workflow_id: str,
                        run_id: str, branch: Optional[int] = None) -> int:
        """The branch's mutable-state history_size: the sum of each
        batch's serialized bytes (the invariant walcheck audits rebuilt
        states against). Lazily cached per batch — the append-only fast
        path serializes only batches the cache hasn't seen; overwrites
        drop the cache. The snapshot writer persists this next to the
        device state so a warm restart recovers history-size accounting
        in O(suffix) instead of re-serializing the prefix."""
        from ..core.codec import serialize_history
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            branches = self._branches.get(key)
            if branches is None:
                raise EntityNotExistsError(
                    f"no history for {workflow_id}/{run_id}")
            index = self._current.get(key, 0) if branch is None else branch
            if index >= len(branches):
                raise EntityNotExistsError(f"no branch {index} for {key}")
            target = branches[index]
            sizes = self._size_cache.setdefault((key, index), [])
            if len(sizes) > len(target):
                del sizes[:]  # stale cache (belt and braces)
            for b in target[len(sizes):]:
                sizes.append(len(serialize_history([HistoryBatch(
                    domain_id=domain_id, workflow_id=workflow_id,
                    run_id=run_id, events=list(b))])))
            return sum(sizes)

    def batch_count(self, domain_id: str, workflow_id: str, run_id: str,
                    branch: Optional[int] = None) -> int:
        """Number of stored batches on a branch — 0 for unknown runs.
        The O(1) probe the batch-range consumers (snapshot hydration,
        the serving chain-break fallback) pair with read_batches_range
        so a cold path never touches the prefix."""
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            branches = self._branches.get(key)
            if branches is None:
                return 0
            index = self._current.get(key, 0) if branch is None else branch
            if index >= len(branches):
                return 0
            return len(branches[index])

    def read_batches_range(self, domain_id: str, workflow_id: str,
                           run_id: str, from_batch: int,
                           branch: Optional[int] = None
                           ) -> List[List[HistoryEvent]]:
        """Only batches[from_batch:] — the batch-range read
        (ReadHistoryBranch with a minNodeID floor): a consumer holding a
        snapshot or resident state at batch count c fetches from c-1
        (the boundary batch, for the content-address CRC check) and
        never deserializes the prefix."""
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            branches = self._branches.get(key)
            if branches is None:
                raise EntityNotExistsError(
                    f"no history for {workflow_id}/{run_id}")
            index = self._current.get(key, 0) if branch is None else branch
            if index >= len(branches):
                raise EntityNotExistsError(f"no branch {index} for {key}")
            return [list(b) for b in branches[index][max(0, from_batch):]]

    def as_history_batches_range(self, domain_id: str, workflow_id: str,
                                 run_id: str, from_batch: int,
                                 branch: Optional[int] = None
                                 ) -> List[HistoryBatch]:
        """read_batches_range in the replay-input shape."""
        return [
            HistoryBatch(domain_id=domain_id, workflow_id=workflow_id,
                         run_id=run_id, events=b)
            for b in self.read_batches_range(domain_id, workflow_id,
                                             run_id, from_batch, branch)
        ]

    def as_history_batches(self, domain_id: str, workflow_id: str, run_id: str,
                           branch: Optional[int] = None) -> List[HistoryBatch]:
        """Batches in the replay-input shape (for the TPU kernel path)."""
        return [
            HistoryBatch(domain_id=domain_id, workflow_id=workflow_id,
                         run_id=run_id, events=b)
            for b in self.read_batches(domain_id, workflow_id, run_id, branch)
        ]

    def read_events_range(self, domain_id: str, workflow_id: str,
                          run_id: str, first_event_id: int,
                          page_size: int,
                          branch: Optional[int] = None) -> List[HistoryEvent]:
        """Ranged read: up to `page_size` events with id >= first_event_id
        (ReadHistoryBranch's paginated contract,
        historyStore.ReadHistoryBranchRequest): the page bounds the
        store→caller bytes — the reads GetWorkflowExecutionHistory and
        the state rebuilder page through."""
        key = (domain_id, workflow_id, run_id)
        with self._lock:
            branches = self._branches.get(key)
            if branches is None:
                raise EntityNotExistsError(
                    f"no history for {workflow_id}/{run_id}")
            index = self._current.get(key, 0) if branch is None else branch
            if index >= len(branches):
                raise EntityNotExistsError(f"no branch {index} for {key}")
            out: List[HistoryEvent] = []
            for b in branches[index]:
                if b and b[-1].id < first_event_id:
                    continue
                for e in b:
                    if e.id >= first_event_id:
                        out.append(e)
                        if len(out) >= page_size:
                            return out
            return out


# ---------------------------------------------------------------------------
# Execution store (ExecutionManager, dataManagerInterfaces.go:1697)
# ---------------------------------------------------------------------------


@dataclass
class CurrentExecution:
    run_id: str
    state: int
    close_status: int


class ExecutionStore:
    """Mutable-state snapshots + current-run pointers, with conditional
    updates on next_event_id and range-ID fencing."""

    def __init__(self, shard_store: ShardStore) -> None:
        self._lock = threading.Lock()
        self._wal = None
        self._shard_store = shard_store
        #: (domain_id, workflow_id, run_id) -> (MutableState, checksum value)
        self._executions: Dict[Tuple[str, str, str], MutableState] = {}
        #: (domain_id, workflow_id) -> CurrentExecution
        self._current: Dict[Tuple[str, str], CurrentExecution] = {}
        #: per-key WRITE VERSION: bumped by EVERY snapshot write (active
        #: update, passive upsert, create, delete) — the execution cache's
        #: revalidation token (execution/cache.go staleness guard)
        self._versions: Dict[Tuple[str, str, str], int] = {}
        #: per-shard execution index: num_shards -> shard -> key set.
        #: Built lazily on the first `list_executions_for_shards` call for
        #: a given shard space, then maintained incrementally by every
        #: writer — a shard steal's hydration reads O(stolen keys), never
        #: O(all executions) (migration.MigrationManager's access pattern)
        self._shard_index: Dict[int, Dict[int, set]] = {}

    def _check_fence(self, shard_id: int, range_id: int) -> None:
        cur = self._shard_store.get_or_create(shard_id)
        if cur.range_id != range_id:
            raise ShardOwnershipLostError(
                f"shard {shard_id}: write fenced (range {range_id} != {cur.range_id})"
            )

    def create_workflow(self, shard_id: int, range_id: int, ms: MutableState) -> None:
        """CreateWorkflowExecution (shard/context.go:586): fails when a
        current run exists and is still open."""
        crashpoints.fire("store.execution.create_workflow")
        info = ms.execution_info
        key = (info.domain_id, info.workflow_id, info.run_id)
        cur_key = (info.domain_id, info.workflow_id)
        with self._lock:
            self._check_fence(shard_id, range_id)
            cur = self._current.get(cur_key)
            from ..core.enums import WorkflowState
            if cur is not None and cur.state != WorkflowState.Completed:
                raise WorkflowAlreadyStartedError(
                    f"{info.workflow_id}: run {cur.run_id} still open"
                )
            self._executions[key] = ms
            self._versions[key] = self._versions.get(key, 0) + 1
            self._shard_index_add_locked(key)
            self._current[cur_key] = CurrentExecution(
                run_id=info.run_id, state=info.state, close_status=info.close_status
            )
            self._log_current(cur_key)

    def update_workflow(self, shard_id: int, range_id: int, ms: MutableState,
                        expected_next_event_id: int) -> None:
        """UpdateWorkflowExecution (shard/context.go:696): conditional on the
        next-event-id recorded when the transaction loaded the state."""
        crashpoints.fire("store.execution.update_workflow")
        info = ms.execution_info
        key = (info.domain_id, info.workflow_id, info.run_id)
        with self._lock:
            self._check_fence(shard_id, range_id)
            existing = self._executions.get(key)
            if existing is None:
                raise EntityNotExistsError(f"no execution {key}")
            if existing.execution_info.next_event_id != expected_next_event_id:
                raise ConditionFailedError(
                    f"{info.workflow_id}: next_event_id "
                    f"{existing.execution_info.next_event_id} != expected "
                    f"{expected_next_event_id}"
                )
            self._executions[key] = ms
            self._versions[key] = self._versions.get(key, 0) + 1
            cur_key = (info.domain_id, info.workflow_id)
            cur = self._current.get(cur_key)
            if cur is not None and cur.run_id == info.run_id:
                self._current[cur_key] = CurrentExecution(
                    run_id=info.run_id, state=info.state,
                    close_status=info.close_status,
                )
                self._log_current(cur_key)
            return self._versions[key]

    def check_next_event_id(self, domain_id: str, workflow_id: str,
                            run_id: str, expected: int) -> None:
        """Read-only precheck of update_workflow's CAS condition. Committing
        a transaction as events→tasks→state leaves the CAS last, so without
        this a concurrent loser would overwrite the winner's committed
        history tail (append_batch overwrite semantics) before failing its
        own CAS. The reference prevents this with the per-workflow context
        lock (execution/cache.go:182); here the shard holds its lock across
        the compound commit and fails the loser before any write."""
        with self._lock:
            existing = self._executions.get((domain_id, workflow_id, run_id))
            if existing is None:
                raise EntityNotExistsError(
                    f"no execution {workflow_id}/{run_id}")
            if existing.execution_info.next_event_id != expected:
                raise ConditionFailedError(
                    f"{workflow_id}: next_event_id "
                    f"{existing.execution_info.next_event_id} != expected "
                    f"{expected}")

    def upsert_workflow(self, ms: MutableState, set_current: bool = True) -> None:
        """UpdateWorkflowExecutionAsPassive analog: unconditional snapshot
        upsert, used by the standby-side replicator (the replicator is the
        only writer on a passive cluster, so no range-ID fence or
        next-event-id condition applies). `set_current=False` persists the
        run WITHOUT taking the current-run pointer — the zombie-run seat
        (ndc/transaction_manager.go createAsZombie)."""
        info = ms.execution_info
        with self._lock:
            key = (info.domain_id, info.workflow_id, info.run_id)
            self._executions[key] = ms
            self._versions[key] = self._versions.get(key, 0) + 1
            self._shard_index_add_locked(key)
            if set_current:
                self._current[(info.domain_id, info.workflow_id)] = CurrentExecution(
                    run_id=info.run_id, state=info.state,
                    close_status=info.close_status,
                )
                self._log_current((info.domain_id, info.workflow_id))

    def _log_current(self, cur_key) -> None:
        if self._wal is not None:
            from .durability import current_run_record
            self._wal.append(current_run_record(
                cur_key[0], cur_key[1], self._current[cur_key]))

    def restore_current(self, domain_id: str, workflow_id: str,
                        cur: CurrentExecution) -> None:
        """Recovery: install a current-run pointer directly."""
        with self._lock:
            self._current[(domain_id, workflow_id)] = cur

    def drop_current(self, domain_id: str, workflow_id: str) -> None:
        """Recovery: remove a pointer whose run has no history (torn
        start); the workflow id becomes startable again."""
        with self._lock:
            self._current.pop((domain_id, workflow_id), None)

    def list_current_pointers(self):
        with self._lock:
            return list(self._current.items())

    def get_workflow(self, domain_id: str, workflow_id: str, run_id: str
                     ) -> MutableState:
        with self._lock:
            ms = self._executions.get((domain_id, workflow_id, run_id))
            if ms is None:
                raise EntityNotExistsError(f"no execution {workflow_id}/{run_id}")
            return ms

    def get_current_run_id(self, domain_id: str, workflow_id: str) -> str:
        with self._lock:
            cur = self._current.get((domain_id, workflow_id))
            if cur is None:
                raise EntityNotExistsError(f"no current execution {workflow_id}")
            return cur.run_id

    def delete_workflow(self, domain_id: str, workflow_id: str,
                        run_id: str) -> bool:
        """Drop a run's snapshot; the current pointer is released only if
        it points at this run and the run is closed (a live current run is
        never deleted by retention)."""
        from ..core.enums import WorkflowState
        with self._lock:
            key = (domain_id, workflow_id, run_id)
            existed = self._executions.pop(key, None) is not None
            if existed:
                self._versions[key] = self._versions.get(key, 0) + 1
                self._shard_index_drop_locked(key)
            cur = self._current.get((domain_id, workflow_id))
            if (cur is not None and cur.run_id == run_id
                    and cur.state == WorkflowState.Completed):
                self._current.pop((domain_id, workflow_id), None)
            return existed

    def get_version(self, domain_id: str, workflow_id: str,
                    run_id: str) -> int:
        """The per-key write version (cache revalidation token): cheap to
        probe, bumped by every writer — active, passive, or admin."""
        with self._lock:
            return self._versions.get((domain_id, workflow_id, run_id), 0)

    def list_executions(self) -> List[Tuple[str, str, str]]:
        with self._lock:
            return list(self._executions.keys())

    # -- per-shard execution index -----------------------------------------

    def _shard_index_add_locked(self, key: Tuple[str, str, str]) -> None:
        from .membership import shard_id_for_workflow
        for num_shards, buckets in self._shard_index.items():
            buckets.setdefault(
                shard_id_for_workflow(key[1], num_shards), set()).add(key)

    def _shard_index_drop_locked(self, key: Tuple[str, str, str]) -> None:
        from .membership import shard_id_for_workflow
        for num_shards, buckets in self._shard_index.items():
            buckets.get(shard_id_for_workflow(key[1], num_shards),
                        set()).discard(key)

    def list_executions_for_shards(self, shard_ids, num_shards: int
                                   ) -> List[Tuple[str, str, str]]:
        """Keys living in `shard_ids` of a `num_shards` shard space
        (membership.shard_id_for_workflow). The first call for a shard
        space pays one full scan to build its index; every later call —
        the migration hydration path — reads only the requested buckets,
        O(stolen keys). Sorted, so hydration order is deterministic."""
        from .membership import shard_id_for_workflow
        with self._lock:
            buckets = self._shard_index.get(int(num_shards))
            if buckets is None:
                buckets = {}
                for key in self._executions:
                    buckets.setdefault(
                        shard_id_for_workflow(key[1], num_shards),
                        set()).add(key)
                self._shard_index[int(num_shards)] = buckets
            out: List[Tuple[str, str, str]] = []
            for s in shard_ids:
                out.extend(buckets.get(int(s), ()))
            return sorted(out)


# ---------------------------------------------------------------------------
# Task store (TaskManager, dataManagerInterfaces.go:1749; matching
# taskListManager lease + task id blocks)
# ---------------------------------------------------------------------------


@dataclass
class TaskListInfo:
    domain_id: str
    name: str
    task_type: int  # TaskListTypeDecision / TaskListTypeActivity
    range_id: int = 0
    ack_level: int = 0


@dataclass
class PersistedTask:
    task_id: int
    domain_id: str
    workflow_id: str
    run_id: str
    schedule_id: int


class TaskStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tasklists: Dict[Tuple[str, str, int], TaskListInfo] = {}
        self._tasks: Dict[Tuple[str, str, int], List[PersistedTask]] = {}

    def lease_task_list(self, domain_id: str, name: str, task_type: int
                        ) -> TaskListInfo:
        """LeaseTaskList: bump range id, invalidating previous lessee
        (matching/taskListManager.go renewLeaseWithRetry:458)."""
        key = (domain_id, name, task_type)
        with self._lock:
            info = self._tasklists.setdefault(
                key, TaskListInfo(domain_id=domain_id, name=name, task_type=task_type)
            )
            info.range_id += 1
            return TaskListInfo(**vars(info))

    def create_tasks(self, info: TaskListInfo, tasks: List[PersistedTask]) -> None:
        key = (info.domain_id, info.name, info.task_type)
        with self._lock:
            cur = self._tasklists.get(key)
            if cur is None or cur.range_id != info.range_id:
                raise ConditionFailedError(
                    f"task list {info.name}: lease lost"
                )
            self._tasks.setdefault(key, []).extend(tasks)

    def get_tasks(self, domain_id: str, name: str, task_type: int,
                  min_task_id: int, batch_size: int = 100) -> List[PersistedTask]:
        key = (domain_id, name, task_type)
        with self._lock:
            return [t for t in self._tasks.get(key, [])
                    if t.task_id > min_task_id][:batch_size]

    def complete_tasks_less_than(self, domain_id: str, name: str,
                                 task_type: int, task_id: int) -> int:
        key = (domain_id, name, task_type)
        with self._lock:
            tasks = self._tasks.get(key, [])
            keep = [t for t in tasks if t.task_id > task_id]
            removed = len(tasks) - len(keep)
            self._tasks[key] = keep
            return removed


# ---------------------------------------------------------------------------
# Domain store (DomainManager, dataManagerInterfaces.go:1793)
# ---------------------------------------------------------------------------


#: DomainStatus (common/persistence DomainStatusRegistered/Deprecated)
DOMAIN_STATUS_REGISTERED = 0
DOMAIN_STATUS_DEPRECATED = 1


@dataclass
class DomainInfo:
    domain_id: str
    name: str
    retention_days: int = 1
    is_active: bool = True
    active_cluster: str = "primary"
    clusters: Tuple[str, ...] = ("primary",)
    failover_version: int = 0
    notification_version: int = 0
    #: DOMAIN_STATUS_*: deprecated domains reject new starts but existing
    #: workflows run to completion (workflowHandler DeprecateDomain)
    status: int = DOMAIN_STATUS_REGISTERED
    description: str = ""
    #: history archival URI ("" = disabled; file://<path> supported) —
    #: retention archives-then-deletes when set (common/archiver)
    history_archival_uri: str = ""


class DomainStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._wal = None
        self._by_id: Dict[str, DomainInfo] = {}
        self._by_name: Dict[str, str] = {}
        #: bumped on every mutation — the DomainCache revalidation token
        self._mutations = 0

    def _log(self, info: "DomainInfo") -> None:
        if self._wal is not None:
            from .durability import domain_record
            self._wal.append(domain_record(info))

    def register(self, info: DomainInfo) -> None:
        with self._lock:
            if info.name in self._by_name:
                raise WorkflowAlreadyStartedError(f"domain {info.name} exists")
            self._by_id[info.domain_id] = info
            self._by_name[info.name] = info.domain_id
            self._mutations += 1
            self._log(info)

    def by_name(self, name: str) -> DomainInfo:
        with self._lock:
            domain_id = self._by_name.get(name)
            if domain_id is None:
                raise EntityNotExistsError(f"domain {name}")
            return self._by_id[domain_id]

    def by_id(self, domain_id: str) -> DomainInfo:
        with self._lock:
            info = self._by_id.get(domain_id)
            if info is None:
                raise EntityNotExistsError(f"domain id {domain_id}")
            return info

    def update(self, info: DomainInfo) -> None:
        with self._lock:
            self._by_id[info.domain_id] = info
            self._mutations += 1
            self._log(info)

    def mutation_version(self) -> int:
        with self._lock:
            return self._mutations

    def list_domains(self) -> List[DomainInfo]:
        with self._lock:
            return list(self._by_id.values())


# ---------------------------------------------------------------------------
# Visibility store (VisibilityManager analog; ES/SQL dual manager later)
# ---------------------------------------------------------------------------


@dataclass
class VisibilityRecord:
    domain_id: str
    workflow_id: str
    run_id: str
    workflow_type: str
    start_time: int
    close_time: int = 0
    close_status: int = -1  # -1 = open
    #: custom search attributes (UpsertWorkflowSearchAttributes decision) —
    #: the advanced-visibility columns the query language filters on
    search_attrs: Dict[str, object] = field(default_factory=dict)


class VisibilityStore:
    """Indexed visibility (the ES tier reframed onto in-store indexes):
    records partition by domain, with secondary indexes on workflow type
    and close status, and a per-domain (start_time, wf, run)-ordered list
    for time-ordered pagination. Query strings compile to a predicate
    PLUS equality hints (visibility_query.compile_query_with_hints); the
    planner intersects index sets from the hints before evaluating the
    predicate, so selective List/Count never scans the domain — the
    esql → index-lookup split without the ES dependency.

    Device tier (engine/visibility_device.py): when
    CADENCE_TPU_VISIBILITY enables it, a columnar device twin of this
    store serves query/query_page/count from HBM — this store stays the
    WRITE-SIDE AUTHORITY (every mutation lands here first and enqueues a
    column delta for the device view), and every device answer is parity
    gateable against the host evaluation below."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: Dict[Tuple[str, str, str], VisibilityRecord] = {}
        #: domain → set of keys (domain partition)
        self._by_domain: Dict[str, set] = {}
        #: (domain, workflow_type) → set of keys
        self._by_type: Dict[Tuple[str, str], set] = {}
        #: (domain, close_status) → set of keys (-1 = open)
        self._by_status: Dict[Tuple[str, int], set] = {}
        #: domain → ascending [(start_time, workflow_id, run_id)]
        self._ordered: Dict[str, List[tuple]] = {}
        #: columnar device twin (engine/visibility_device.py), attached
        #: lazily on the first routed query when the tier is enabled
        self._device = None
        #: cluster registry for the device twin's tpu.visibility series
        #: (None = the process-global default)
        self.metrics = None
        #: where the device twin keeps its columns (None = the card; a
        #: query with the tier on and no card raises)
        self.device = None
        #: monotone mutation sequence — the device view's staleness is
        #: measured as (this - its applied sequence)
        self._seq = 0

    # -- index maintenance (held under self._lock) -------------------------

    def _index_add_locked(self, rec: VisibilityRecord) -> None:
        key = (rec.domain_id, rec.workflow_id, rec.run_id)
        self._by_domain.setdefault(rec.domain_id, set()).add(key)
        self._by_type.setdefault(
            (rec.domain_id, rec.workflow_type), set()).add(key)
        self._by_status.setdefault(
            (rec.domain_id, rec.close_status), set()).add(key)
        bisect.insort(self._ordered.setdefault(rec.domain_id, []),
                      (rec.start_time, rec.workflow_id, rec.run_id))

    def _index_remove_locked(self, rec: VisibilityRecord) -> None:
        key = (rec.domain_id, rec.workflow_id, rec.run_id)
        self._by_domain.get(rec.domain_id, set()).discard(key)
        self._by_type.get((rec.domain_id, rec.workflow_type),
                          set()).discard(key)
        self._by_status.get((rec.domain_id, rec.close_status),
                            set()).discard(key)
        order = self._ordered.get(rec.domain_id, [])
        entry = (rec.start_time, rec.workflow_id, rec.run_id)
        i = bisect.bisect_left(order, entry)
        if i < len(order) and order[i] == entry:
            order.pop(i)

    def _notify_locked(self, rec: VisibilityRecord) -> None:
        """Enqueue the mutated record as a column delta for the device
        view (called under self._lock so delta order equals mutation
        order; the device appender drains asynchronously)."""
        self._seq += 1
        if self._device is not None:
            self._device.enqueue_upsert(self._seq, rec)

    def _notify_delete_locked(self, rec: VisibilityRecord) -> None:
        self._seq += 1
        if self._device is not None:
            self._device.enqueue_delete(
                self._seq, (rec.domain_id, rec.workflow_id, rec.run_id))

    def record_started(self, rec: VisibilityRecord) -> None:
        """Upsert the open-execution record. Under a CONCURRENT task pump
        the close task can land before a retried start task — the start
        write must never resurrect a closed record as open (it merges the
        existing close fields and search attrs instead of replacing)."""
        with self._lock:
            key = (rec.domain_id, rec.workflow_id, rec.run_id)
            existing = self._records.get(key)
            if existing is not None:
                rec.close_time = existing.close_time
                rec.close_status = existing.close_status
                merged = dict(existing.search_attrs)
                merged.update(rec.search_attrs)
                rec.search_attrs = merged
                self._index_remove_locked(existing)
            self._records[key] = rec
            self._index_add_locked(rec)
            self._notify_locked(rec)

    def record_closed(self, domain_id: str, workflow_id: str, run_id: str,
                      close_time: int, close_status: int,
                      workflow_type: str = "", start_time: int = 0) -> None:
        """Upsert close data — creating the record when the start write
        hasn't landed yet (out-of-order under the concurrent pump): a
        closed workflow must never stay listed open forever because its
        start task retried late."""
        with self._lock:
            rec = self._records.get((domain_id, workflow_id, run_id))
            if rec is None:
                rec = VisibilityRecord(
                    domain_id=domain_id, workflow_id=workflow_id,
                    run_id=run_id, workflow_type=workflow_type,
                    start_time=start_time)
                self._records[(domain_id, workflow_id, run_id)] = rec
            else:
                self._index_remove_locked(rec)
            rec.close_time = close_time
            rec.close_status = close_status
            self._index_add_locked(rec)
            self._notify_locked(rec)

    def list_open(self, domain_id: str) -> List[VisibilityRecord]:
        with self._lock:
            keys = self._by_status.get((domain_id, -1), set())
            return [self._records[k] for k in keys]

    def list_closed(self, domain_id: str) -> List[VisibilityRecord]:
        with self._lock:
            keys = (self._by_domain.get(domain_id, set())
                    - self._by_status.get((domain_id, -1), set()))
            return [self._records[k] for k in keys]

    def upsert_search_attributes(self, domain_id: str, workflow_id: str,
                                 run_id: str, attrs: Dict[str, object]) -> None:
        """The UpsertWorkflowSearchAttributes transfer task's visibility
        write (the ES re-index analog)."""
        with self._lock:
            rec = self._records.get((domain_id, workflow_id, run_id))
            if rec is not None:
                rec.search_attrs.update(attrs)
                self._notify_locked(rec)

    def _candidates_locked(self, domain_id: str, hints: dict):
        """Index-reduced candidate key set (None = the whole domain)."""
        sets = []
        if "workflowtype" in hints:
            sets.append(self._by_type.get(
                (domain_id, hints["workflowtype"]), set()))
        if "closestatus" in hints:
            try:
                status = int(hints["closestatus"])
            except (TypeError, ValueError):
                return set()
            sets.append(self._by_status.get((domain_id, status), set()))
        if not sets:
            return None
        out = sets[0]
        for s in sets[1:]:
            out = out & s
        return out

    def _device_view(self):
        """The columnar device twin, created lazily on the first routed
        query when CADENCE_TPU_VISIBILITY enables the tier (bootstrap
        enqueues every existing record under the lock, so the delta
        stream the write hooks feed is gap-free from sequence 1). The
        cheap env probe runs before the module import, so a disabled
        process never pays for the device tier's dependencies."""
        import os
        if not os.environ.get("CADENCE_TPU_VISIBILITY", "").strip():
            return None
        from . import visibility_device as vd
        if not vd.enabled():
            return None
        if self._device is None:
            with self._lock:
                if self._device is None:
                    dev = vd.DeviceVisibilityView(registry=self.metrics,
                                                  device=self.device)
                    for rec in self._records.values():
                        self._seq += 1
                        dev.enqueue_upsert(self._seq, rec)
                    vd.register(dev)
                    self._device = dev
        return self._device

    def _query_locked(self, domain_id: str, pred, hints
                      ) -> List[VisibilityRecord]:
        """Host evaluation (held under self._lock): index intersection
        from the query's equality hints, then the compiled predicate
        over the remainder. The device tier's parity oracle."""
        cands = self._candidates_locked(domain_id, hints)
        if cands is None:
            cands = self._by_domain.get(domain_id, set())
        return [r for r in (self._records[k] for k in cands) if pred(r)]

    def query(self, domain_id: str, query: str) -> List[VisibilityRecord]:
        """Query-filtered list (ListWorkflowExecutions with `query`,
        workflowHandler.go:2837): the columnar device scan when the
        tier is enabled (engine/visibility_device.py — parity-gateable,
        falls back to the host evaluation it is gated against), else
        index intersection + predicate on the host."""
        dev = self._device_view()
        if dev is not None:
            return dev.list(self, domain_id, query)
        from .visibility_query import compile_query_with_hints
        pred, hints = compile_query_with_hints(query)
        with self._lock:
            return self._query_locked(domain_id, pred, hints)

    def _query_page_locked(self, domain_id: str, pred, hints,
                           page_size: int, next_page_token=None):
        out: List[VisibilityRecord] = []
        cands = self._candidates_locked(domain_id, hints)
        order = self._ordered.get(domain_id, [])
        hi = (len(order) if next_page_token is None
              else bisect.bisect_left(order, tuple(next_page_token)))
        i = hi - 1
        while i >= 0 and len(out) < page_size:
            st, wf, run = order[i]
            key = (domain_id, wf, run)
            if cands is None or key in cands:
                rec = self._records.get(key)
                if rec is not None and pred(rec):
                    out.append(rec)
            i -= 1
        more = i >= 0 and len(out) == page_size
        token = ((out[-1].start_time, out[-1].workflow_id, out[-1].run_id)
                 if out and more else None)
        return out, token

    def query_page(self, domain_id: str, query: str, page_size: int,
                   next_page_token=None):
        """One page in StartTime-DESC order (the reference's sort), with
        an opaque resume token: (records, next_token). The token is the
        last returned record's order entry; None when the page ended the
        result set."""
        dev = self._device_view()
        if dev is not None:
            return dev.page(self, domain_id, query, page_size,
                            next_page_token)
        from .visibility_query import compile_query_with_hints
        pred, hints = compile_query_with_hints(query)
        with self._lock:
            return self._query_page_locked(domain_id, pred, hints,
                                           page_size, next_page_token)

    def count(self, domain_id: str, query: str = "") -> int:
        """CountWorkflowExecutions (workflowHandler.go:3322): on the
        device tier a count never materializes records — the mask
        kernel's scalar reduction is the whole readback."""
        dev = self._device_view()
        if dev is not None:
            return dev.count(self, domain_id, query)
        return len(self.query(domain_id, query))

    def all_closed(self) -> List[VisibilityRecord]:
        with self._lock:
            return [r for r in self._records.values() if r.close_status != -1]

    def delete_record(self, domain_id: str, workflow_id: str,
                      run_id: str) -> None:
        with self._lock:
            rec = self._records.pop((domain_id, workflow_id, run_id), None)
            if rec is not None:
                self._index_remove_locked(rec)
                self._notify_delete_locked(rec)


# ---------------------------------------------------------------------------
# Queue store (QueueManager, dataManagerInterfaces.go:1806 — replication/DLQ)
# ---------------------------------------------------------------------------


class QueueStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._wal = None
        self._queues: Dict[str, List[object]] = {}
        #: (queue, consumer) → ack index. The reference persists these as
        #: per-cluster QueueMetadata ack levels (persistence/queue.go
        #: UpdateAckLevel); a restarted or re-elected consumer resumes
        #: from here instead of re-applying the whole stream.
        self._acks: Dict[Tuple[str, str], int] = {}

    def enqueue(self, queue: str, payload: object) -> int:
        crashpoints.fire("store.queue.enqueue")
        with self._lock:
            q = self._queues.setdefault(queue, [])
            q.append(payload)
            if self._wal is not None:
                from .durability import queue_record
                self._wal.append(queue_record(queue, payload))
            return len(q) - 1

    def read(self, queue: str, from_index: int, count: int = 100
             ) -> List[Tuple[int, object]]:
        with self._lock:
            q = self._queues.get(queue, [])
            return [(i, q[i]) for i in range(from_index, min(len(q), from_index + count))]

    def size(self, queue: str) -> int:
        with self._lock:
            return len(self._queues.get(queue, []))

    def set_ack(self, queue: str, consumer: str, index: int) -> None:
        """Monotonic: concurrent consumers (a leadership flap) can only
        advance the level, never rewind it."""
        with self._lock:
            key = (queue, consumer)
            if index <= self._acks.get(key, -1):
                return
            self._acks[key] = index
            if self._wal is not None:
                from .durability import queue_ack_record
                self._wal.append(queue_ack_record(queue, consumer, index))

    def get_ack(self, queue: str, consumer: str) -> int:
        """The next index the consumer should read (0 when never acked)."""
        with self._lock:
            return self._acks.get((queue, consumer), -1) + 1

    def ack_levels(self, queue: str) -> Dict[str, int]:
        """consumer → acked index, the admin/DescribeQueue surface."""
        with self._lock:
            return {c: i for (q, c), i in self._acks.items() if q == queue}

    def snapshot(self) -> Tuple[Dict[str, int], Dict[Tuple[str, str], int]]:
        """(queue → size, (queue, consumer) → acked index) in one lock
        hold — the walcheck fsck's consistency view."""
        with self._lock:
            return ({q: len(items) for q, items in self._queues.items()},
                    dict(self._acks))

    def purge(self, queue: str) -> int:
        """Drop every item (the DLQ purge verb) AND the queue's consumer
        ack levels: an ack level outliving a purge points past the queue's
        contents, so items re-enqueued after the purge would be silently
        skipped by every resuming consumer. Whole-queue only: index
        cursors of streaming consumers stay valid because purged queues
        are read-whole (DLQ semantics), never cursor-streamed. Recovery
        replays the purge record through this same method, so the ack
        reset survives a crash too."""
        with self._lock:
            n = len(self._queues.get(queue, []))
            self._queues[queue] = []
            stale_acks = [k for k in self._acks if k[0] == queue]
            for k in stale_acks:
                del self._acks[k]
            if self._wal is not None and (n or stale_acks):
                from .durability import queue_purge_record
                self._wal.append(queue_purge_record(queue))
            return n


class ShardTaskQueues:
    """Durable per-shard transfer/timer task queues.

    In the reference these rows live in the executions table and are read
    via ExecutionManager.GetTransferTasks / GetTimerIndexTasks
    (dataManagerInterfaces.go:1712,:1732); keeping them in the store — not
    in the shard context — is what lets a new owner resume a dead host's
    queue processing from the persisted ack level."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._transfer: Dict[int, List[tuple]] = {}
        self._timer: Dict[int, List[tuple]] = {}

    def insert_transfer(self, shard_id: int, rows: Iterable[tuple]) -> None:
        with self._lock:
            self._transfer.setdefault(shard_id, []).extend(rows)

    def insert_timer(self, shard_id: int, rows: Iterable[tuple]) -> None:
        with self._lock:
            self._timer.setdefault(shard_id, []).extend(rows)

    def read_transfer(self, shard_id: int, ack_level: int,
                      batch: int = 100) -> List[tuple]:
        with self._lock:
            return [t for t in self._transfer.get(shard_id, [])
                    if t[0] > ack_level][:batch]

    def read_timer_due(self, shard_id: int, now_nanos: int,
                       batch: int = 100) -> List[tuple]:
        with self._lock:
            due = [t for t in self._timer.get(shard_id, []) if t[0] <= now_nanos]
            due.sort(key=lambda t: (t[0], t[1]))
            return due[:batch]

    def complete_transfer_below(self, shard_id: int, level: int) -> None:
        with self._lock:
            self._transfer[shard_id] = [
                t for t in self._transfer.get(shard_id, []) if t[0] > level
            ]

    def complete_timer(self, shard_id: int, task_id: int) -> None:
        with self._lock:
            self._timer[shard_id] = [
                t for t in self._timer.get(shard_id, []) if t[1] != task_id
            ]


@dataclass
class Stores:
    """One bundle per "cluster" (resource.Resource analog)."""

    shard: ShardStore = field(default_factory=ShardStore)
    history: HistoryStore = field(default_factory=HistoryStore)
    task: TaskStore = field(default_factory=TaskStore)
    domain: DomainStore = field(default_factory=DomainStore)
    visibility: VisibilityStore = field(default_factory=VisibilityStore)
    queue: QueueStore = field(default_factory=QueueStore)
    shard_tasks: ShardTaskQueues = field(default_factory=ShardTaskQueues)
    execution: ExecutionStore = None  # type: ignore[assignment]
    snapshot: object = None  # SnapshotStore (engine/snapshot.py)

    def __post_init__(self) -> None:
        if self.execution is None:
            self.execution = ExecutionStore(self.shard)
        if self.snapshot is None:
            from .snapshot import SnapshotStore
            self.snapshot = SnapshotStore()
        # content-address invalidation rides the history store: every
        # writer that rewrites bytes under a snapshot funnels through it
        self.history._snapshots = self.snapshot

    def attach_wal(self, wal) -> None:
        """Route every durable mutation through one write-ahead log
        (matching + shard task queues are rebuilt by the task refresher on
        recovery and stay memory-only — see engine/durability.py).

        Log appends run INSIDE each store's lock on purpose: recovery
        replays records in file order and the history/queue replay relies
        on per-branch contiguity, so the log order must equal mutation
        order. The cost under the lock is a buffered write + flush (no
        fsync by default); moving it outside would require per-run
        sequence numbers to make replay order-insensitive."""
        self.wal = wal
        for store in (self.shard, self.history, self.domain, self.queue,
                      self.execution, self.snapshot):
            store._wal = wal
