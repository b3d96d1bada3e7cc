"""Task refresher: recompute all transfer/timer tasks from mutable state.

Reference: service/history/execution/mutable_state_task_refresher.go:77
(RefreshTasks) — called when a workflow changes hands: standby promotion
after failover, state rebuild, admin refresh. A standby applies replicated
state with no tasks (the replicator discards them, replication.py), so a
promoted standby must regenerate every dispatchable task — pending decision,
unstarted activities, user/activity timers, unstarted children, undelivered
external cancels/signals, the workflow-timeout timer — or pre-existing work
silently stalls after failover.

The refresher appends into ms.transfer_tasks / ms.timer_tasks exactly like
replay-time generation; the caller (HistoryEngine.refresh_tasks) drains
them into the owning shard's durable queues.
"""
from __future__ import annotations

from typing import Dict

from ..core.enums import (
    EMPTY_EVENT_ID,
    TIMER_TASK_STATUS_NONE,
    TimerTaskType,
    TransferTaskType,
    WorkflowState,
)
from ..core.events import HistoryEvent
from ..oracle import task_generator as taskgen
from ..oracle.mutable_state import GeneratedTask, MutableState, seconds_to_nanos


def sweep_refresh(stores, route, domain_id: str = None) -> int:
    """Refresh every CURRENT run (one domain, or all when domain_id is
    None): the promotion sweep after failover and the post-recovery sweep
    share this. Completed runs are included — their close fan-out /
    retention timer may not have run on this cluster yet. Zombie runs
    (not holding the current-run pointer after NDC arbitration) are
    skipped: refreshing them would execute a losing run. Returns the
    number of tasks created."""
    import time

    from .controller import ShardNotOwnedError
    from .persistence import EntityNotExistsError, ShardOwnershipLostError
    created = 0
    for d_id, wf_id, run_id in stores.execution.list_executions():
        if domain_id is not None and d_id != domain_id:
            continue
        try:
            if stores.execution.get_current_run_id(d_id, wf_id) != run_id:
                continue
        except EntityNotExistsError:
            continue
        # promotion sweeps run exactly while shards are changing hands, so
        # a fenced write (stale ring view on the routed host) is a ROUTINE
        # transient here, not a failure: the fence rejected the whole
        # update, and refresh is idempotent, so re-route and retry
        for attempt in range(8):
            try:
                created += route(wf_id).refresh_tasks(d_id, wf_id, run_id)
                break
            except (ShardOwnershipLostError, ShardNotOwnedError):
                if attempt == 7:
                    raise
                time.sleep(0.25 * (attempt + 1))
    return created


def refresh_tasks(ms: MutableState, events_by_id: Dict[int, HistoryEvent]) -> None:
    """Recompute every outstanding task from mutable state
    (mutable_state_task_refresher.go:77 RefreshTasks).

    `events_by_id` is the events-cache analog: external cancel/signal
    targets live only in their initiated events (the reference's refresher
    reads them through the events cache too, task_refresher.go:365-437).
    """
    info = ms.execution_info

    if info.state == WorkflowState.Completed:
        # refreshTasksForWorkflowClose: the close fan-out may not have run
        # on this cluster yet; CloseExecution delivery is idempotent
        # (visibility upsert; parent notification no-ops once resolved)
        ms.add_transfer_task(GeneratedTask(
            kind="transfer", task_type=TransferTaskType.CloseExecution,
            version=ms.current_version))
        retention_nanos = ms.domain_entry.retention_days * 24 * 3600 * 1_000_000_000
        close_ts = info.start_timestamp
        completion = events_by_id.get(info.next_event_id - 1)
        if completion is not None:
            close_ts = completion.timestamp
        ms.add_timer_task(GeneratedTask(
            kind="timer", task_type=TimerTaskType.DeleteHistoryEvent,
            version=ms.current_version,
            visibility_timestamp=close_ts + retention_nanos))
        return

    # refreshTasksForWorkflowStart: workflow-timeout timer + (when the first
    # decision is still pending its backoff) the backoff timer
    ms.add_timer_task(GeneratedTask(
        kind="timer", task_type=TimerTaskType.WorkflowTimeout,
        version=ms.current_version,
        visibility_timestamp=info.start_timestamp
        + seconds_to_nanos(info.workflow_timeout)))
    start_event = events_by_id.get(1)
    if (info.decision_schedule_id == EMPTY_EVENT_ID and start_event is not None
            and (start_event.get("first_decision_task_backoff_seconds", 0) or 0) > 0):
        taskgen.generate_delayed_decision_tasks(ms, start_event)

    # refreshTasksForRecordWorkflowStarted (visibility upsert is idempotent)
    ms.add_transfer_task(GeneratedTask(
        kind="transfer", task_type=TransferTaskType.RecordWorkflowStarted,
        version=ms.current_version))

    # refreshTasksForDecision (task_refresher.go:219-258)
    if info.decision_schedule_id != EMPTY_EVENT_ID:
        if info.decision_started_id == EMPTY_EVENT_ID:
            taskgen.generate_decision_schedule_tasks(ms, info.decision_schedule_id)
        else:
            taskgen.generate_decision_start_tasks(ms, info.decision_schedule_id)

    # refreshTasksForActivity (:260-306): clear created-bits, re-dispatch
    # unstarted activities through the same generator as replay, recreate
    # the earliest activity timer
    for ai in ms.pending_activity_info_ids.values():
        ai.timer_task_status = TIMER_TASK_STATUS_NONE
        if ai.started_id == EMPTY_EVENT_ID and ai.schedule_id != EMPTY_EVENT_ID:
            event = events_by_id.get(ai.schedule_id)
            if event is not None:
                taskgen.generate_activity_transfer_tasks(ms, event)
    taskgen.generate_activity_timer_tasks(ms)

    # refreshTasksForTimer (:308-336)
    for ti in ms.pending_timer_info_ids.values():
        ti.task_status = TIMER_TASK_STATUS_NONE
    taskgen.generate_user_timer_tasks(ms)

    # refreshTasksForChildWorkflow (:338-363): unstarted children re-dispatch
    for ci in ms.pending_child_execution_info_ids.values():
        if ci.started_id == EMPTY_EVENT_ID:
            event = events_by_id.get(ci.initiated_id)
            if event is not None:
                taskgen.generate_child_workflow_tasks(ms, event)

    # refreshTasksForRequestCancelExternalWorkflow (:365-400)
    for rci in ms.pending_request_cancel_info_ids.values():
        event = events_by_id.get(rci.initiated_id)
        if event is not None:
            taskgen.generate_request_cancel_external_tasks(ms, event)

    # refreshTasksForSignalExternalWorkflow (:402-437)
    for si in ms.pending_signal_info_ids.values():
        event = events_by_id.get(si.initiated_id)
        if event is not None:
            taskgen.generate_signal_external_tasks(ms, event)
