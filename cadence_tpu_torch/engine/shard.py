"""Shard context: per-shard metadata, task ID allocation, range-ID fencing.

Reference: service/history/shard/context.go — the shard owns a range ID
renewed on acquisition (renewRangeLocked:1068); every persistence write is
fenced by it so a stale owner self-closes; transfer task IDs are allocated
from range-scoped blocks (GenerateTransferTaskID:68); ack levels checkpoint
queue progress in ShardInfo (dataManagerInterfaces.go:275-295).
"""
from __future__ import annotations

import threading
from typing import List, Optional

from ..oracle.mutable_state import GeneratedTask, MutableState
from .persistence import ShardInfo, ShardOwnershipLostError, Stores

# rangeSizeBits analog: each range owns this many task IDs
RANGE_SIZE = 1 << 20


class ShardContext:
    def __init__(self, shard_id: int, owner: str, stores: Stores) -> None:
        self.shard_id = shard_id
        self.owner = owner
        self._stores = stores
        self._lock = threading.RLock()
        self._info: Optional[ShardInfo] = None
        self._next_task_id = 0
        self._max_task_id = 0
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    def acquire(self) -> None:
        """Take ownership: bump range ID (renewRangeLocked)."""
        with self._lock:
            info = self._stores.shard.get_or_create(self.shard_id)
            prev_range = info.range_id
            prev_owner = info.owner
            info.range_id += 1
            info.owner = self.owner
            self._stores.shard.update(info, expected_range_id=prev_range)
            self._info = info
            self._next_task_id = info.range_id * RANGE_SIZE
            self._max_task_id = (info.range_id + 1) * RANGE_SIZE
            self._closed = False
        from ..utils.log import DEFAULT_LOGGER
        DEFAULT_LOGGER.info("shard acquired", component="shard",
                            shard_id=self.shard_id, owner=self.owner,
                            previous_owner=prev_owner or "<none>",
                            range_id=info.range_id)

    def _renew_range_locked(self) -> None:
        """Fresh task-ID block for the CURRENT owner: the CAS is against our
        cached range ID, so a deposed owner fails with ShardOwnershipLost
        instead of silently re-stealing the shard (shard/context.go:1068)."""
        info = ShardInfo(**vars(self._info))
        expected = info.range_id
        info.range_id += 1
        try:
            self._stores.shard.update(info, expected_range_id=expected)
        except ShardOwnershipLostError:
            self._closed = True
            raise
        self._info = info
        self._next_task_id = info.range_id * RANGE_SIZE
        self._max_task_id = (info.range_id + 1) * RANGE_SIZE

    def close(self) -> None:
        with self._lock:
            self._closed = True

    @property
    def is_closed(self) -> bool:
        """True once this context was deposed (fenced) or released — the
        controller evicts and re-acquires such contexts."""
        with self._lock:
            return self._closed

    @property
    def range_id(self) -> int:
        with self._lock:
            self._ensure_open()
            return self._info.range_id

    def _ensure_open(self) -> None:
        if self._closed or self._info is None:
            raise ShardOwnershipLostError(f"shard {self.shard_id} closed")

    # -- task IDs ----------------------------------------------------------

    def generate_task_id(self) -> int:
        """GenerateTransferTaskID: monotonic within the owned range."""
        with self._lock:
            self._ensure_open()
            if self._next_task_id >= self._max_task_id:
                self._renew_range_locked()
            tid = self._next_task_id
            self._next_task_id += 1
            return tid

    # -- fenced persistence ------------------------------------------------

    def create_workflow(self, ms: MutableState) -> None:
        with self._lock:
            self._ensure_open()
            try:
                self._stores.execution.create_workflow(
                    self.shard_id, self._info.range_id, ms
                )
            except ShardOwnershipLostError:
                self._closed = True
                raise

    def append_history(self, domain_id: str, workflow_id: str, run_id: str,
                       events, branch=None, blob=None) -> None:
        """Fenced history append: a deposed owner must NOT reach the
        history store — with node-overwrite append semantics a stale
        writer could truncate committed events before its state update
        hits the range fence. Ownership is re-validated against the shard
        store's CURRENT range id, the same check every write makes."""
        with self._lock:
            self._ensure_open()
            current = self._stores.shard.get_or_create(self.shard_id)
            if current.range_id != self._info.range_id:
                self._closed = True
                raise ShardOwnershipLostError(
                    f"shard {self.shard_id}: append fenced (range "
                    f"{self._info.range_id} != {current.range_id})")
            self._stores.history.append_batch(domain_id, workflow_id,
                                              run_id, events, branch=branch,
                                              blob=blob)

    def update_workflow(self, ms: MutableState,
                        expected_next_event_id: int) -> int:
        """Returns the store's new per-key write version (the execution
        cache's writeback token)."""
        with self._lock:
            self._ensure_open()
            try:
                return self._stores.execution.update_workflow(
                    self.shard_id, self._info.range_id, ms, expected_next_event_id
                )
            except ShardOwnershipLostError:
                self._closed = True
                raise

    def commit_workflow(self, ms: MutableState, expected_next_event_id: int,
                        events, transfer: List[GeneratedTask],
                        timer: List[GeneratedTask],
                        events_blob: Optional[bytes] = None) -> None:
        """Atomic transaction commit: events → tasks → fenced state update
        under ONE shard lock hold, with the state CAS prechecked first.

        The reference write order (execution/context.go:105) appends events
        before the conditional state update; it is safe there because the
        per-workflow context lock (execution/cache.go:182) serializes
        writers of the same workflow. This engine has no context cache, so
        the shard lock plays that role — and the precheck makes a
        concurrent loser fail BEFORE its append can truncate the winner's
        committed history tail (append_batch node-overwrite semantics)."""
        info = ms.execution_info
        with self._lock:
            self._ensure_open()
            self._stores.execution.check_next_event_id(
                info.domain_id, info.workflow_id, info.run_id,
                expected_next_event_id)
            self.append_history(info.domain_id, info.workflow_id,
                                info.run_id, events, blob=events_blob)
            self.insert_tasks(info.domain_id, info.workflow_id, info.run_id,
                              transfer, timer)
            return self.update_workflow(ms, expected_next_event_id)

    # -- shard task queues -------------------------------------------------

    def insert_tasks(self, domain_id: str, workflow_id: str, run_id: str,
                     transfer: List[GeneratedTask],
                     timer: List[GeneratedTask]) -> None:
        """Persist generated tasks into the shard's durable queues, stamping
        task IDs (shard/context.go allocates task IDs inside the update
        transaction); rows survive this owner's death."""
        with self._lock:
            self._ensure_open()
            self._stores.shard_tasks.insert_transfer(self.shard_id, [
                (self.generate_task_id(), domain_id, workflow_id, run_id, t)
                for t in transfer
            ])
            self._stores.shard_tasks.insert_timer(self.shard_id, [
                (t.visibility_timestamp, self.generate_task_id(),
                 domain_id, workflow_id, run_id, t)
                for t in timer
            ])

    def read_transfer_tasks(self, ack_level: int, batch: int = 100) -> List[tuple]:
        return self._stores.shard_tasks.read_transfer(self.shard_id, ack_level,
                                                      batch)

    def read_timer_tasks(self, now_nanos: int, ack_level: int,
                         batch: int = 100) -> List[tuple]:
        return self._stores.shard_tasks.read_timer_due(self.shard_id, now_nanos,
                                                       batch)

    def update_transfer_ack_level(self, level: int) -> None:
        with self._lock:
            self._ensure_open()
            info = self._info
            info.transfer_ack_level = max(info.transfer_ack_level, level)
            self._stores.shard.update(info, expected_range_id=info.range_id)
            self._stores.shard_tasks.complete_transfer_below(self.shard_id,
                                                             info.transfer_ack_level)

    def update_timer_ack_level(self, task_id: int) -> None:
        with self._lock:
            self._ensure_open()
            self._stores.shard_tasks.complete_timer(self.shard_id, task_id)

    @property
    def transfer_ack_level(self) -> int:
        with self._lock:
            self._ensure_open()
            return self._info.transfer_ack_level

    @property
    def transfer_queue_states(self) -> list:
        with self._lock:
            self._ensure_open()
            return [list(q) for q in self._info.transfer_queue_states]

    def update_transfer_queue_states(self, states: list,
                                     min_ack: int) -> None:
        """Persist every processing queue's (level, ack, filter) plus the
        GC floor = min over queues — the fenced write the next owner
        resumes from (queue/interface.go ProcessingQueueState)."""
        with self._lock:
            self._ensure_open()
            info = self._info
            info.transfer_queue_states = [list(q) for q in states]
            info.transfer_ack_level = max(info.transfer_ack_level, min_ack)
            self._stores.shard.update(info, expected_range_id=info.range_id)
            self._stores.shard_tasks.complete_transfer_below(
                self.shard_id, info.transfer_ack_level)
