"""Reference mutable state: the Python semantic oracle for the device replay kernel.

This module re-implements, in plain Python, the passive-side (replication /
rebuild) semantics of the reference engine's `mutableStateBuilder`:

- struct fields:      service/history/execution/mutable_state_builder.go:83-172
- Replicate* methods: mutable_state_builder.go:1751-3810
- decision manager:   service/history/execution/mutable_state_decision_task_manager.go
- state transitions:  common/persistence/workflowExecutionInfo.go:44-165
- version histories:  common/persistence/versionHistory.go

It is the oracle against which the batched device kernel is differentially
tested (checksum parity), playing the role the Go `stateBuilder` plays in
BASELINE.json's north star. It is deliberately one-workflow-at-a-time and
readable; throughput comes from the device kernel, not from here.

Known deliberate deviation: where the reference reads the wall clock
(`timeSource.Now()`, e.g. transient-decision scheduled timestamps at
mutable_state_decision_task_manager.go:191,662) the oracle uses the current
event's timestamp so replay is deterministic. None of those timestamps feed
the mutable-state checksum (see core/checksum.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.enums import (
    EMPTY_EVENT_ID,
    EMPTY_UUID,
    EMPTY_VERSION,
    FIRST_EVENT_ID,
    NANOS_PER_SECOND,
    TIMER_TASK_STATUS_NONE,
    CloseStatus,
    WorkflowState,
)


class ReplayError(Exception):
    """Raised on invalid history/state transitions.

    Mirrors the reference's error returns (ErrMissingActivityInfo,
    ErrMissingChildWorkflowInfo, invalid state transition, ...). The device
    kernel reports the same conditions through a sticky per-workflow error
    flag instead of raising.
    """


# ---------------------------------------------------------------------------
# Version histories (reference: common/persistence/versionHistory.go)
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class VersionHistoryItem:
    event_id: int
    version: int


@dataclass(slots=True)
class VersionHistory:
    branch_token: bytes = b""
    items: List[VersionHistoryItem] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.items

    def last_item(self) -> VersionHistoryItem:
        if not self.items:
            raise ReplayError("version history is empty")
        return self.items[-1]

    def add_or_update_item(self, event_id: int, version: int) -> None:
        """Reference: versionHistory.go:193-225."""
        if not self.items:
            self.items.append(VersionHistoryItem(event_id, version))
            return
        last = self.items[-1]
        if version < last.version:
            raise ReplayError(
                f"cannot update version history with a lower version {version} < {last.version}"
            )
        if event_id <= last.event_id:
            raise ReplayError(
                f"cannot add version history with a lower event id {event_id} <= {last.event_id}"
            )
        if version > last.version:
            self.items.append(VersionHistoryItem(event_id, version))
        else:
            last.event_id = event_id

    def find_lca_item(self, remote_items: List[VersionHistoryItem]
                      ) -> VersionHistoryItem:
        """Lowest common ancestor of this branch vs a remote item list
        (versionHistory.go:239-271 FindLCAItem): walk both item lists from
        the tail; the first version match contributes min(event_id)."""
        li = len(self.items) - 1
        ri = len(remote_items) - 1
        while li >= 0 and ri >= 0:
            local = self.items[li]
            remote = remote_items[ri]
            if local.version == remote.version:
                return VersionHistoryItem(
                    min(local.event_id, remote.event_id), local.version)
            if local.version > remote.version:
                li -= 1
            else:
                ri -= 1
        raise ReplayError("version histories have no common ancestor")

    def is_lca_appendable(self, lca: VersionHistoryItem) -> bool:
        """versionHistory.go:227-237: the remote branch extends this one
        iff the LCA is this branch's last item."""
        last = self.last_item()
        return last.event_id == lca.event_id and last.version == lca.version

    def duplicate_until_lca(self, lca: VersionHistoryItem) -> "VersionHistory":
        """versionHistory.go:136-158 DuplicateUntilLCAItem: the fork's item
        list — every item strictly below the LCA version plus the LCA-capped
        item of its version."""
        items: List[VersionHistoryItem] = []
        for item in self.items:
            if item.version < lca.version and item.event_id <= lca.event_id:
                items.append(VersionHistoryItem(item.event_id, item.version))
            elif item.version == lca.version:
                items.append(VersionHistoryItem(
                    min(item.event_id, lca.event_id), item.version))
                return VersionHistory(items=items)
            else:
                break
        raise ReplayError(f"version history cannot be forked at {lca}")


@dataclass(slots=True)
class VersionHistories:
    current_index: int = 0
    histories: List[VersionHistory] = field(default_factory=lambda: [VersionHistory()])

    def current(self) -> VersionHistory:
        return self.histories[self.current_index]

    def find_lca_index_and_item(self, remote_items: List[VersionHistoryItem]
                                ) -> tuple:
        """versionHistories.go FindLCAVersionHistoryIndexAndItem: the local
        branch sharing the deepest common ancestor with the remote items."""
        best_index = -1
        best_item: Optional[VersionHistoryItem] = None
        best_len = 0
        for index, history in enumerate(self.histories):
            if history.is_empty():
                continue
            try:
                item = history.find_lca_item(remote_items)
            except ReplayError:
                continue
            # tie-break on equal LCA event ids: prefer the branch with the
            # shorter item list, so an incoming batch appends to the branch
            # whose head IS the LCA instead of forking a duplicate
            # (versionHistories.go FindLCAVersionHistoryIndexAndItem)
            if (best_item is None or item.event_id > best_item.event_id
                    or (item.event_id == best_item.event_id
                        and len(history.items) < best_len)):
                best_index, best_item = index, item
                best_len = len(history.items)
        if best_item is None:
            raise ReplayError("no local branch shares an ancestor with remote")
        return best_index, best_item


# ---------------------------------------------------------------------------
# Pending-item infos (reference: common/persistence/dataManagerInterfaces.go
# ActivityInfo:752, TimerInfo:792, ChildExecutionInfo:801, RequestCancelInfo:818,
# SignalInfo:826)
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class ActivityInfo:
    version: int
    schedule_id: int
    scheduled_event_batch_id: int
    scheduled_time: int  # unix nanos
    started_id: int
    started_time: int  # unix nanos; 0 == zero time
    activity_id: str
    domain_id: str
    task_list: str
    schedule_to_start_timeout: int
    schedule_to_close_timeout: int
    start_to_close_timeout: int
    heartbeat_timeout: int
    cancel_requested: bool = False
    cancel_request_id: int = EMPTY_EVENT_ID
    request_id: str = ""
    last_heartbeat_updated_time: int = 0
    timer_task_status: int = TIMER_TASK_STATUS_NONE
    attempt: int = 0
    has_retry_policy: bool = False
    initial_interval: int = 0
    backoff_coefficient: float = 0.0
    maximum_interval: int = 0
    maximum_attempts: int = 0
    expiration_time: int = 0  # unix nanos; 0 == zero time
    non_retriable_errors: List[str] = field(default_factory=list)
    last_failure_reason: str = ""
    last_failure_details: bytes = b""
    started_identity: str = ""
    last_worker_identity: str = ""
    last_heartbeat_timeout_visibility: int = 0  # unix seconds


@dataclass(slots=True)
class TimerInfo:
    version: int
    timer_id: str
    started_id: int
    expiry_time: int  # unix nanos
    task_status: int = TIMER_TASK_STATUS_NONE


@dataclass(slots=True)
class ChildExecutionInfo:
    version: int
    initiated_id: int
    initiated_event_batch_id: int
    started_id: int
    started_workflow_id: str
    started_run_id: str = ""
    create_request_id: str = ""
    domain_id: str = ""
    workflow_type_name: str = ""
    parent_close_policy: int = 0
    #: the StartChildWorkflowExecution decision's task list (empty =
    #: inherit the parent's, the pre-attr behavior); host-side only —
    #: never part of the canonical payload
    task_list: str = ""


@dataclass(slots=True)
class RequestCancelInfo:
    version: int
    initiated_event_batch_id: int
    initiated_id: int
    cancel_request_id: str = ""


@dataclass(slots=True)
class SignalInfo:
    version: int
    initiated_event_batch_id: int
    initiated_id: int
    signal_request_id: str = ""
    signal_name: str = ""


@dataclass(slots=True)
class DecisionInfo:
    """Reference: service/history/execution/mutable_state.go DecisionInfo."""

    version: int = EMPTY_VERSION
    schedule_id: int = EMPTY_EVENT_ID
    started_id: int = EMPTY_EVENT_ID
    request_id: str = EMPTY_UUID
    decision_timeout: int = 0
    task_list: str = ""
    attempt: int = 0
    scheduled_timestamp: int = 0
    started_timestamp: int = 0
    original_scheduled_timestamp: int = 0


# ---------------------------------------------------------------------------
# Execution info (reference: dataManagerInterfaces.go WorkflowExecutionInfo:296-353)
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class ExecutionInfo:
    domain_id: str = ""
    workflow_id: str = ""
    run_id: str = ""
    first_execution_run_id: str = ""
    parent_domain_id: str = ""
    parent_workflow_id: str = ""
    parent_run_id: str = ""
    initiated_id: int = EMPTY_EVENT_ID
    completion_event_batch_id: int = EMPTY_EVENT_ID
    task_list: str = ""
    workflow_type_name: str = ""
    workflow_timeout: int = 0  # seconds
    decision_start_to_close_timeout: int = 0  # seconds
    state: int = WorkflowState.Created
    close_status: int = CloseStatus.Nothing
    last_first_event_id: int = FIRST_EVENT_ID
    last_event_task_id: int = 0
    next_event_id: int = FIRST_EVENT_ID
    last_processed_event: int = EMPTY_EVENT_ID
    start_timestamp: int = 0  # unix nanos
    create_request_id: str = ""
    signal_count: int = 0
    cron_schedule: str = ""
    #: start event's FirstDecisionTaskBackoffSeconds, kept here so cron
    #: anchor math (GetCronBackoffDuration) needn't re-read the start event
    first_decision_backoff: int = 0

    sticky_task_list: str = ""
    sticky_schedule_to_start_timeout: int = 0
    client_library_version: str = ""
    client_feature_version: str = ""
    client_impl: str = ""

    decision_version: int = EMPTY_VERSION
    decision_schedule_id: int = EMPTY_EVENT_ID
    decision_started_id: int = EMPTY_EVENT_ID
    decision_request_id: str = EMPTY_UUID
    decision_timeout: int = 0
    decision_attempt: int = 0
    decision_started_timestamp: int = 0
    decision_scheduled_timestamp: int = 0
    decision_original_scheduled_timestamp: int = 0

    cancel_requested: bool = False
    cancel_request_id: str = ""

    attempt: int = 0  # workflow retry attempt
    has_retry_policy: bool = False
    initial_interval: int = 0
    backoff_coefficient: float = 0.0
    maximum_interval: int = 0
    maximum_attempts: int = 0
    expiration_seconds: int = 0
    expiration_time: int = 0  # unix nanos
    non_retriable_errors: List[str] = field(default_factory=list)

    memo: Dict[str, bytes] = field(default_factory=dict)
    search_attributes: Dict[str, bytes] = field(default_factory=dict)

    def update_workflow_state_close_status(self, state: int, close_status: int) -> None:
        """State-machine guard; reference workflowExecutionInfo.go:44-165."""
        cur = self.state
        invalid = False
        if cur == WorkflowState.Void:
            pass  # no validation
        elif cur == WorkflowState.Created:
            if state in (WorkflowState.Created, WorkflowState.Running, WorkflowState.Zombie):
                invalid = close_status != CloseStatus.Nothing
            elif state == WorkflowState.Completed:
                invalid = close_status not in (
                    CloseStatus.Terminated,
                    CloseStatus.TimedOut,
                    CloseStatus.ContinuedAsNew,
                )
            else:
                raise ReplayError(f"unknown workflow state: {state}")
        elif cur == WorkflowState.Running:
            if state == WorkflowState.Created:
                invalid = True
            elif state in (WorkflowState.Running, WorkflowState.Zombie):
                invalid = close_status != CloseStatus.Nothing
            elif state == WorkflowState.Completed:
                invalid = close_status == CloseStatus.Nothing
            else:
                raise ReplayError(f"unknown workflow state: {state}")
        elif cur == WorkflowState.Completed:
            if state == WorkflowState.Completed:
                invalid = close_status != self.close_status
            elif state in (WorkflowState.Created, WorkflowState.Running, WorkflowState.Zombie):
                invalid = True
            else:
                raise ReplayError(f"unknown workflow state: {state}")
        elif cur == WorkflowState.Zombie:
            if state in (WorkflowState.Created, WorkflowState.Running):
                invalid = close_status != CloseStatus.Nothing
            elif state in (WorkflowState.Completed, WorkflowState.Zombie):
                invalid = close_status == CloseStatus.Nothing
            else:
                raise ReplayError(f"unknown workflow state: {state}")
        else:
            raise ReplayError(f"unknown workflow state: {cur}")

        if invalid:
            raise ReplayError(
                f"unable to change workflow state from {cur} to {state}, close status {close_status}"
            )
        self.state = state
        self.close_status = close_status


# ---------------------------------------------------------------------------
# Tasks generated during replay (reference: persistence task structs referenced
# from mutable_state_task_generator.go; only replay-relevant fields kept)
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class GeneratedTask:
    """One transfer/timer/cross-cluster task produced by replay.

    `kind` is "transfer" | "timer" | "cross_cluster"; `task_type` is the
    TransferTaskType / TimerTaskType value.
    """

    kind: str
    task_type: int
    version: int
    visibility_timestamp: int = 0  # unix nanos; transfer tasks: 0 (set by shard)
    event_id: int = 0  # schedule/initiated/started event id, when applicable
    timeout_type: int = 0
    attempt: int = 0
    task_list: str = ""
    target_domain_id: str = ""
    target_workflow_id: str = ""
    target_run_id: str = ""
    target_child_workflow_only: bool = False


class MutableState:
    """Oracle mutable state: pending maps + execution info + generated tasks.

    Mirrors mutableStateBuilder's replication-relevant fields
    (mutable_state_builder.go:83-172).
    """

    __slots__ = (
        "execution_info",
        "pending_activity_info_ids",
        "pending_activity_id_to_event_id",
        "pending_timer_info_ids",
        "pending_timer_event_id_to_id",
        "pending_child_execution_info_ids",
        "pending_request_cancel_info_ids",
        "pending_signal_info_ids",
        "version_histories",
        "current_version",
        "transfer_tasks",
        "timer_tasks",
        "cross_cluster_tasks",
        "domain_entry",
        "history_size",
        "buffered_events",
        "signal_requested_ids",
    )

    def __init__(self, domain_entry: Optional["DomainEntry"] = None) -> None:
        self.execution_info = ExecutionInfo()
        self.pending_activity_info_ids: Dict[int, ActivityInfo] = {}
        self.pending_activity_id_to_event_id: Dict[str, int] = {}
        self.pending_timer_info_ids: Dict[str, TimerInfo] = {}
        self.pending_timer_event_id_to_id: Dict[int, str] = {}
        self.pending_child_execution_info_ids: Dict[int, ChildExecutionInfo] = {}
        self.pending_request_cancel_info_ids: Dict[int, RequestCancelInfo] = {}
        self.pending_signal_info_ids: Dict[int, SignalInfo] = {}
        self.version_histories = VersionHistories()
        self.current_version: int = EMPTY_VERSION
        self.transfer_tasks: List[GeneratedTask] = []
        self.timer_tasks: List[GeneratedTask] = []
        self.cross_cluster_tasks: List[GeneratedTask] = []
        self.domain_entry = domain_entry if domain_entry is not None else DomainEntry()
        self.history_size: int = 0
        #: events received while a decision is in flight, awaiting ID
        #: assignment at decision close (mutable_state_builder.go:112-114
        #: bufferedEvents / updateBufferedEvents); entries carry
        #: BUFFERED_EVENT_ID until FlushBufferedEvents reassigns them
        self.buffered_events: List["HistoryEvent"] = []
        #: applied external-signal request ids (mutable_state_builder.go
        #: signalRequestedIDs / AddSignalRequested): the at-least-once
        #: signal legs dedup against this so a redelivered signal does not
        #: append a duplicate WorkflowExecutionSignaled event
        self.signal_requested_ids: set = set()

    # -- version bookkeeping ------------------------------------------------

    def update_current_version(self, version: int, force_update: bool) -> None:
        """Reference: mutable_state_builder.go:495-533."""
        if self.execution_info.state == WorkflowState.Completed:
            # always pin to last write version once completed
            self.current_version = self.get_last_write_version()
            return
        history = self.version_histories.current()
        if not history.is_empty():
            self.current_version = history.last_item().version
        if version > self.current_version or force_update:
            self.current_version = version

    def get_last_write_version(self) -> int:
        return self.version_histories.current().last_item().version

    # -- misc helpers -------------------------------------------------------

    def clear_stickyness(self) -> None:
        """Reference: mutable_state_builder.go:1504-1511."""
        info = self.execution_info
        info.sticky_task_list = ""
        info.sticky_schedule_to_start_timeout = 0
        info.client_library_version = ""
        info.client_feature_version = ""
        info.client_impl = ""

    def get_next_event_id(self) -> int:
        return self.execution_info.next_event_id

    def has_parent_execution(self) -> bool:
        """Reference: mutableStateBuilder.HasParentExecution (parent ids set)."""
        return (
            self.execution_info.parent_workflow_id != ""
            and self.execution_info.parent_run_id != ""
        )

    # -- pending-map delete helpers ----------------------------------------

    def delete_activity(self, schedule_id: int) -> None:
        """Reference: mutable_state_builder.go:1310 DeleteActivity."""
        ai = self.pending_activity_info_ids.pop(schedule_id, None)
        if ai is None:
            raise ReplayError(f"missing activity info for schedule id {schedule_id}")
        self.pending_activity_id_to_event_id.pop(ai.activity_id, None)

    def delete_user_timer(self, timer_id: str) -> None:
        """Reference: mutable_state_builder.go:1390 DeleteUserTimer."""
        ti = self.pending_timer_info_ids.pop(timer_id, None)
        if ti is None:
            raise ReplayError(f"missing timer info for timer id {timer_id}")
        self.pending_timer_event_id_to_id.pop(ti.started_id, None)

    def delete_pending_child_execution(self, initiated_id: int) -> None:
        if self.pending_child_execution_info_ids.pop(initiated_id, None) is None:
            raise ReplayError(f"missing child execution info {initiated_id}")

    def delete_pending_request_cancel(self, initiated_id: int) -> None:
        if self.pending_request_cancel_info_ids.pop(initiated_id, None) is None:
            raise ReplayError(f"missing request cancel info {initiated_id}")

    def delete_pending_signal(self, initiated_id: int) -> None:
        if self.pending_signal_info_ids.pop(initiated_id, None) is None:
            raise ReplayError(f"missing signal info {initiated_id}")

    # -- task emission ------------------------------------------------------

    def add_transfer_task(self, task: GeneratedTask) -> None:
        self.transfer_tasks.append(task)

    def add_timer_task(self, task: GeneratedTask) -> None:
        self.timer_tasks.append(task)

    def add_cross_cluster_task(self, task: GeneratedTask) -> None:
        self.cross_cluster_tasks.append(task)


@dataclass(slots=True)
class DomainEntry:
    """Minimal domain metadata used by replay task generation.

    Reference analog: cache.DomainCacheEntry (common/cache/domainCache.go).
    Replay in this framework is the passive-side bulk path, so domains default
    to passive; the active engine sets is_active=True.
    """

    domain_id: str = "default-domain-id"
    name: str = "default-domain"
    is_active: bool = False
    retention_days: int = 1  # defaultWorkflowRetentionInDays, task_generator.go:118
    failover_version: int = 0


def seconds_to_nanos(seconds: int) -> int:
    return int(seconds) * NANOS_PER_SECOND
