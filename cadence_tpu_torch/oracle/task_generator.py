"""Transfer/timer task generation during replay.

Reference: service/history/execution/mutable_state_task_generator.go.
Replay also emits tasks (decision dispatch, activity dispatch, timeouts,
close/retention), so kernel parity requires generating them too.

Deliberate deviation: `getNextDecisionTimeout` (task_generator.go:1051-1064)
adds random jitter to the decision start-to-close backoff; here the jitter
draw is fixed to 0 so replay is deterministic (visibility timestamps are
scheduling hints and never feed the mutable-state checksum).
"""
from __future__ import annotations

from ..core.enums import (
    CloseStatus,
    ContinueAsNewInitiator,
    TimeoutType,
    TimerTaskType,
    TransferTaskType,
    WorkflowBackoffTimeoutType,
)
from ..core.events import HistoryEvent
from .mutable_state import GeneratedTask, MutableState, ReplayError, seconds_to_nanos
from .timer_sequence import create_next_activity_timer, create_next_user_timer

# Decision retry backoff constants, task_generator.go:119-121
DEFAULT_INIT_INTERVAL_FOR_DECISION_RETRY_NANOS = 60 * 1_000_000_000
DEFAULT_MAX_INTERVAL_FOR_DECISION_RETRY_NANOS = 300 * 1_000_000_000
DEFAULT_JITTER_COEFFICIENT = 0.2

# Dynamic-config default: normal (non-sticky) decisions get no
# schedule-to-start timer (service/history/config NormalDecisionScheduleToStartMaxAttempts
# defaults to 0); stickiness is cleared on the replay path (state_builder.go:108),
# matching the standby-side comment at state_builder.go:201-203.
NORMAL_DECISION_SCHEDULE_TO_START_MAX_ATTEMPTS = 0


def generate_record_workflow_started_tasks(ms: MutableState, start_event: HistoryEvent) -> None:
    """Reference: task_generator.go:301-313."""
    ms.add_transfer_task(
        GeneratedTask(
            kind="transfer",
            task_type=TransferTaskType.RecordWorkflowStarted,
            version=start_event.version,
        )
    )


def generate_workflow_start_tasks(ms: MutableState, start_time: int, start_event: HistoryEvent) -> None:
    """Workflow-timeout timer; reference: task_generator.go:143-166."""
    info = ms.execution_info
    backoff = seconds_to_nanos(start_event.get("first_decision_task_backoff_seconds", 0) or 0)
    timeout_ts = start_time + seconds_to_nanos(info.workflow_timeout) + backoff
    attempt = start_event.get("attempt", 0) or 0
    if attempt > 0 and info.expiration_time != 0 and timeout_ts > info.expiration_time:
        timeout_ts = info.expiration_time
    ms.add_timer_task(
        GeneratedTask(
            kind="timer",
            task_type=TimerTaskType.WorkflowTimeout,
            version=start_event.version,
            visibility_timestamp=timeout_ts,
        )
    )


def generate_delayed_decision_tasks(ms: MutableState, start_event: HistoryEvent) -> None:
    """First-decision backoff timer; reference: task_generator.go:260-299."""
    backoff = seconds_to_nanos(start_event.get("first_decision_task_backoff_seconds", 0) or 0)
    execution_ts = start_event.timestamp + backoff
    initiator = start_event.get("initiator")
    timeout_type = WorkflowBackoffTimeoutType.Cron  # noParentWorkflow default, :271
    if initiator is not None:
        if initiator == ContinueAsNewInitiator.RetryPolicy:
            timeout_type = WorkflowBackoffTimeoutType.Retry
        elif initiator == ContinueAsNewInitiator.CronSchedule:
            timeout_type = WorkflowBackoffTimeoutType.Cron
        elif initiator == ContinueAsNewInitiator.Decider:
            raise ReplayError("continue as new initiator & first decision delay not 0")
        else:
            raise ReplayError(f"unknown initiator retry policy: {initiator}")
    ms.add_timer_task(
        GeneratedTask(
            kind="timer",
            task_type=TimerTaskType.WorkflowBackoffTimer,
            version=start_event.version,
            visibility_timestamp=execution_ts,
            timeout_type=timeout_type,
        )
    )


def _decision_schedule_to_start_timeout(ms: MutableState) -> int:
    """Seconds; reference: mutable_state_decision_task_manager.go:765-782."""
    info = ms.execution_info
    if info.sticky_task_list != "":
        return info.sticky_schedule_to_start_timeout
    if info.decision_attempt < NORMAL_DECISION_SCHEDULE_TO_START_MAX_ATTEMPTS:
        raise ReplayError("normal decision schedule-to-start timers not modeled")
    return 0


def generate_decision_schedule_tasks(ms: MutableState, decision_schedule_id: int) -> None:
    """Reference: task_generator.go:315-350."""
    info = ms.execution_info
    if info.decision_schedule_id != decision_schedule_id:
        raise ReplayError(f"cannot get pending decision {decision_schedule_id}")
    task_list = info.sticky_task_list if info.sticky_task_list else info.task_list
    ms.add_transfer_task(
        GeneratedTask(
            kind="transfer",
            task_type=TransferTaskType.DecisionTask,
            version=info.decision_version,
            event_id=info.decision_schedule_id,
            task_list=task_list,
        )
    )
    timeout_s = _decision_schedule_to_start_timeout(ms)
    if timeout_s != 0:
        ms.add_timer_task(
            GeneratedTask(
                kind="timer",
                task_type=TimerTaskType.DecisionTimeout,
                version=info.decision_version,
                visibility_timestamp=info.decision_scheduled_timestamp + seconds_to_nanos(timeout_s),
                timeout_type=TimeoutType.ScheduleToStart,
                event_id=info.decision_schedule_id,
                attempt=info.decision_attempt,
            )
        )


def get_next_decision_timeout_nanos(attempt: int, default_start_to_close_nanos: int) -> int:
    """Deterministic variant of task_generator.go:1051-1064 (jitter draw = 0)."""
    if attempt <= 1:
        return default_start_to_close_nanos
    interval = float(DEFAULT_INIT_INTERVAL_FOR_DECISION_RETRY_NANOS) * (2.0 ** (attempt - 2))
    interval = min(interval, float(DEFAULT_MAX_INTERVAL_FOR_DECISION_RETRY_NANOS))
    return int(interval * (1 - DEFAULT_JITTER_COEFFICIENT))


def generate_decision_start_tasks(ms: MutableState, decision_schedule_id: int) -> None:
    """Decision start-to-close timeout timer; reference: task_generator.go:352-388."""
    info = ms.execution_info
    if info.decision_schedule_id != decision_schedule_id:
        raise ReplayError(f"cannot get pending decision {decision_schedule_id}")
    start_to_close = seconds_to_nanos(info.decision_timeout)
    if info.decision_attempt > 1:
        start_to_close = get_next_decision_timeout_nanos(
            info.decision_attempt, seconds_to_nanos(info.decision_start_to_close_timeout)
        )
        info.decision_timeout = start_to_close // 1_000_000_000  # override, :374
    ms.add_timer_task(
        GeneratedTask(
            kind="timer",
            task_type=TimerTaskType.DecisionTimeout,
            version=info.decision_version,
            visibility_timestamp=info.decision_started_timestamp + start_to_close,
            timeout_type=TimeoutType.StartToClose,
            event_id=info.decision_schedule_id,
            attempt=info.decision_attempt,
        )
    )


def generate_activity_transfer_tasks(ms: MutableState, event: HistoryEvent) -> None:
    """Reference: task_generator.go:390-428."""
    ai = ms.pending_activity_info_ids.get(event.id)
    if ai is None:
        raise ReplayError(f"cannot get pending activity {event.id}")
    ms.add_transfer_task(
        GeneratedTask(
            kind="transfer",
            task_type=TransferTaskType.ActivityTask,
            version=ai.version,
            event_id=ai.schedule_id,
            task_list=ai.task_list,
            target_domain_id=ai.domain_id,
        )
    )


def generate_activity_retry_tasks(ms: MutableState, activity_schedule_id: int) -> None:
    """Reference: task_generator.go:430-449."""
    ai = ms.pending_activity_info_ids.get(activity_schedule_id)
    if ai is None:
        raise ReplayError(f"cannot get pending activity {activity_schedule_id}")
    ms.add_timer_task(
        GeneratedTask(
            kind="timer",
            task_type=TimerTaskType.ActivityRetryTimer,
            version=ai.version,
            visibility_timestamp=ai.scheduled_time,
            event_id=ai.schedule_id,
            attempt=ai.attempt,
        )
    )


def generate_child_workflow_tasks(ms: MutableState, event: HistoryEvent) -> None:
    """Reference: task_generator.go:451-498 (same-cluster path)."""
    ci = ms.pending_child_execution_info_ids.get(event.id)
    if ci is None:
        raise ReplayError(f"cannot get pending child workflow {event.id}")
    ms.add_transfer_task(
        GeneratedTask(
            kind="transfer",
            task_type=TransferTaskType.StartChildExecution,
            version=ci.version,
            event_id=ci.initiated_id,
            target_domain_id=ci.domain_id or ms.execution_info.domain_id,
            target_workflow_id=ci.started_workflow_id,
        )
    )


def generate_request_cancel_external_tasks(ms: MutableState, event: HistoryEvent) -> None:
    """Reference: task_generator.go:500-549 (same-cluster path)."""
    if event.id not in ms.pending_request_cancel_info_ids:
        raise ReplayError(f"cannot get pending request cancel {event.id}")
    ms.add_transfer_task(
        GeneratedTask(
            kind="transfer",
            task_type=TransferTaskType.CancelExecution,
            version=event.version,
            event_id=event.id,
            target_domain_id=event.get("domain_id") or ms.execution_info.domain_id,
            target_workflow_id=event.get("workflow_id", ""),
            target_run_id=event.get("run_id", ""),
            target_child_workflow_only=bool(event.get("child_workflow_only", False)),
        )
    )


def generate_signal_external_tasks(ms: MutableState, event: HistoryEvent) -> None:
    """Reference: task_generator.go:551-600 (same-cluster path)."""
    if event.id not in ms.pending_signal_info_ids:
        raise ReplayError(f"cannot get pending signal external {event.id}")
    ms.add_transfer_task(
        GeneratedTask(
            kind="transfer",
            task_type=TransferTaskType.SignalExecution,
            version=event.version,
            event_id=event.id,
            target_domain_id=event.get("domain_id") or ms.execution_info.domain_id,
            target_workflow_id=event.get("workflow_id", ""),
            target_run_id=event.get("run_id", ""),
            target_child_workflow_only=bool(event.get("child_workflow_only", False)),
        )
    )


def generate_workflow_search_attr_tasks(ms: MutableState) -> None:
    """Reference: task_generator.go:602-612."""
    ms.add_transfer_task(
        GeneratedTask(
            kind="transfer",
            task_type=TransferTaskType.UpsertWorkflowSearchAttributes,
            version=ms.current_version,
        )
    )


def generate_workflow_close_tasks(ms: MutableState, close_event: HistoryEvent) -> None:
    """Reference: task_generator.go:168-258.

    Replay is the passive-side path (`!isActive`, :180-185): exactly one
    CloseExecution transfer task plus the retention-driven history-deletion
    timer. The active-side cross-cluster fan-out lives in the host engine.
    """
    domain = ms.domain_entry
    if not domain.is_active:
        ms.add_transfer_task(
            GeneratedTask(
                kind="transfer",
                task_type=TransferTaskType.CloseExecution,
                version=close_event.version,
            )
        )
    else:
        # active same-cluster path: record child completion for parent, then
        # a single CloseExecution task (no cross-cluster children modeled here)
        if ms.has_parent_execution() and ms.execution_info.close_status != CloseStatus.ContinuedAsNew:
            ms.add_transfer_task(
                GeneratedTask(
                    kind="transfer",
                    task_type=TransferTaskType.RecordChildExecutionCompleted,
                    version=close_event.version,
                    target_domain_id=ms.execution_info.parent_domain_id,
                    target_workflow_id=ms.execution_info.parent_workflow_id,
                    target_run_id=ms.execution_info.parent_run_id,
                )
            )
        ms.add_transfer_task(
            GeneratedTask(
                kind="transfer",
                task_type=TransferTaskType.CloseExecution,
                version=close_event.version,
            )
        )
    retention_nanos = domain.retention_days * 24 * 3600 * 1_000_000_000
    ms.add_timer_task(
        GeneratedTask(
            kind="timer",
            task_type=TimerTaskType.DeleteHistoryEvent,
            version=close_event.version,
            visibility_timestamp=close_event.timestamp + retention_nanos,
        )
    )


def generate_activity_timer_tasks(ms: MutableState) -> None:
    """Reference: task_generator.go:911-915."""
    create_next_activity_timer(ms)


def generate_user_timer_tasks(ms: MutableState) -> None:
    """Reference: task_generator.go:917-921."""
    create_next_user_timer(ms)
