"""Activity retry: transient re-attempt without history events.

Reference: mutableStateBuilder.RetryActivity
(service/history/execution/mutable_state_builder.go:3812-3866) + the
backoff math in execution/retry.go:31-80. A failing activity with a retry
policy is NOT closed with a failure event; its ActivityInfo is reset for
the next attempt and an ActivityRetryTimer re-dispatches it — history only
records the final outcome (the transient started event is flushed when the
activity finally closes, mutable_state_builder.go:2199).
"""
from __future__ import annotations

from ..core.enums import EMPTY_EVENT_ID, TIMER_TASK_STATUS_NONE
from ..utils.backoff import NO_BACKOFF, get_backoff_interval
from . import task_generator as taskgen
from .mutable_state import ActivityInfo, MutableState


def retry_activity(ms: MutableState, ai: ActivityInfo, now_nanos: int,
                   failure_reason: str, failure_details: bytes = b"") -> bool:
    """Attempt a transient retry; True when the activity will re-run
    (RetryActivity, mutable_state_builder.go:3812)."""
    if not ai.has_retry_policy or ai.cancel_requested:
        return False
    backoff_nanos = get_backoff_interval(
        now_nanos=now_nanos,
        expiration_time_nanos=ai.expiration_time,
        curr_attempt=ai.attempt,
        max_attempts=ai.maximum_attempts,
        init_interval_seconds=ai.initial_interval,
        max_interval_seconds=ai.maximum_interval,
        backoff_coefficient=ai.backoff_coefficient,
        failure_reason=failure_reason,
        non_retriable_errors=ai.non_retriable_errors,
    )
    if backoff_nanos == NO_BACKOFF:
        return False

    ai.version = ms.current_version
    ai.attempt += 1
    ai.scheduled_time = now_nanos + backoff_nanos  # next schedule time
    ai.started_id = EMPTY_EVENT_ID
    ai.request_id = ""
    ai.started_time = 0
    ai.timer_task_status = TIMER_TASK_STATUS_NONE
    ai.last_failure_reason = failure_reason
    ai.last_worker_identity = ai.started_identity
    ai.last_failure_details = failure_details
    taskgen.generate_activity_retry_tasks(ms, ai.schedule_id)
    return True
