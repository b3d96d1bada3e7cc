"""User/activity timer sequence: picks the next timer task to create.

Reference: service/history/execution/timer_sequence.go.
Only the replay-relevant surface (CreateNextUserTimer / CreateNextActivityTimer
and the load-and-sort logic) is implemented; `IsExpired` belongs to the timer
queue processor in `engine/`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..core.enums import (
    EMPTY_EVENT_ID,
    TIMER_TASK_STATUS_CREATED,
    TIMER_TYPE_TO_STATUS_MASK,
    TimeoutType,
    TimerTaskType,
)
from .mutable_state import GeneratedTask, MutableState, ReplayError, seconds_to_nanos


@dataclass(slots=True, frozen=True)
class TimerSequenceID:
    """Reference: timer_sequence.go:71-77; sort order :459-493
    (timestamp, event id, timer type)."""

    event_id: int
    timestamp: int  # unix nanos
    timer_type: int
    timer_created: bool
    attempt: int

    def sort_key(self):
        return (self.timestamp, self.event_id, self.timer_type)


def load_and_sort_user_timers(ms: MutableState) -> List[TimerSequenceID]:
    """Reference: timer_sequence.go:201-217."""
    timers = [
        TimerSequenceID(
            event_id=ti.started_id,
            timestamp=ti.expiry_time,
            timer_type=TimeoutType.StartToClose,
            timer_created=ti.task_status == TIMER_TASK_STATUS_CREATED,
            attempt=0,
        )
        for ti in ms.pending_timer_info_ids.values()
    ]
    timers.sort(key=TimerSequenceID.sort_key)
    return timers


def load_and_sort_activity_timers(ms: MutableState) -> List[TimerSequenceID]:
    """Reference: timer_sequence.go:219-254 (schedule-to-close,
    schedule-to-start, start-to-close, heartbeat per pending activity)."""
    timers: List[TimerSequenceID] = []
    for ai in ms.pending_activity_info_ids.values():
        if ai.schedule_id == EMPTY_EVENT_ID:
            continue  # not scheduled yet (retry backoff), :274,:301,:323

        # schedule-to-close (:296-316): always applicable once scheduled
        timers.append(
            TimerSequenceID(
                event_id=ai.schedule_id,
                timestamp=ai.scheduled_time + seconds_to_nanos(ai.schedule_to_close_timeout),
                timer_type=TimeoutType.ScheduleToClose,
                timer_created=bool(ai.timer_task_status & TIMER_TYPE_TO_STATUS_MASK[TimeoutType.ScheduleToClose]),
                attempt=ai.attempt,
            )
        )
        if ai.started_id == EMPTY_EVENT_ID:
            # schedule-to-start (:269-294): only while not started
            timers.append(
                TimerSequenceID(
                    event_id=ai.schedule_id,
                    timestamp=ai.scheduled_time + seconds_to_nanos(ai.schedule_to_start_timeout),
                    timer_type=TimeoutType.ScheduleToStart,
                    timer_created=bool(ai.timer_task_status & TIMER_TYPE_TO_STATUS_MASK[TimeoutType.ScheduleToStart]),
                    attempt=ai.attempt,
                )
            )
        else:
            # start-to-close (:318-343): only once started
            timers.append(
                TimerSequenceID(
                    event_id=ai.schedule_id,
                    timestamp=ai.started_time + seconds_to_nanos(ai.start_to_close_timeout),
                    timer_type=TimeoutType.StartToClose,
                    timer_created=bool(ai.timer_task_status & TIMER_TYPE_TO_STATUS_MASK[TimeoutType.StartToClose]),
                    attempt=ai.attempt,
                )
            )
            # heartbeat (:346-381): started and heartbeat timeout configured
            if ai.heartbeat_timeout > 0:
                last_heartbeat = max(ai.started_time, ai.last_heartbeat_updated_time)
                timers.append(
                    TimerSequenceID(
                        event_id=ai.schedule_id,
                        timestamp=last_heartbeat + seconds_to_nanos(ai.heartbeat_timeout),
                        timer_type=TimeoutType.Heartbeat,
                        timer_created=bool(ai.timer_task_status & TIMER_TYPE_TO_STATUS_MASK[TimeoutType.Heartbeat]),
                        attempt=ai.attempt,
                    )
                )
    timers.sort(key=TimerSequenceID.sort_key)
    return timers


def create_next_user_timer(ms: MutableState) -> bool:
    """Reference: timer_sequence.go:127-160."""
    timers = load_and_sort_user_timers(ms)
    if not timers:
        return False
    first = timers[0]
    if first.timer_created:
        return False
    timer_id = ms.pending_timer_event_id_to_id.get(first.event_id)
    if timer_id is None:
        raise ReplayError(f"unable to load timer info {first.event_id}")
    ti = ms.pending_timer_info_ids[timer_id]
    ti.task_status = TIMER_TASK_STATUS_CREATED
    ms.add_timer_task(
        GeneratedTask(
            kind="timer",
            task_type=TimerTaskType.UserTimer,
            version=ms.current_version,
            visibility_timestamp=first.timestamp,
            event_id=first.event_id,
        )
    )
    return True


def create_next_activity_timer(ms: MutableState) -> bool:
    """Reference: timer_sequence.go:162-199."""
    timers = load_and_sort_activity_timers(ms)
    if not timers:
        return False
    first = timers[0]
    if first.timer_created:
        return False
    ai = ms.pending_activity_info_ids.get(first.event_id)
    if ai is None:
        raise ReplayError(f"unable to load activity info {first.event_id}")
    ai.timer_task_status |= TIMER_TYPE_TO_STATUS_MASK[TimeoutType(first.timer_type)]
    if first.timer_type == TimeoutType.Heartbeat:
        ai.last_heartbeat_timeout_visibility = first.timestamp // 1_000_000_000
    ms.add_timer_task(
        GeneratedTask(
            kind="timer",
            task_type=TimerTaskType.ActivityTimeout,
            version=ms.current_version,
            visibility_timestamp=first.timestamp,
            event_id=first.event_id,
            timeout_type=first.timer_type,
            attempt=first.attempt,
        )
    )
    return True
