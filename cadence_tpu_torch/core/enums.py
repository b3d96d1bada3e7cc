"""Core enums and sentinel constants for the Cadence replay port.

These mirror the reference engine's wire-visible enumerations so that event
streams and mutable state are semantically comparable with the Go engine:

- event types:      common/types/shared.go:3273-3356 (iota order)
- workflow states:  common/persistence/dataManagerInterfaces.go:117-124
- close statuses:   common/persistence/dataManagerInterfaces.go:127-135
- timeout types:    common/types/shared.go (TimeoutType iota)
- task types:       common/persistence/dataManagerInterfaces.go:149-190
- sentinels:        common/constants.go:30-58

The integer values are load-bearing: they are the lane values in the packed
event tensors consumed by the device replay kernel, and several of them
(state, close status, decision fields) feed the mutable-state checksum.
"""
from __future__ import annotations

import enum


class EventType(enum.IntEnum):
    """History event types, in the reference's iota order.

    Reference: common/types/shared.go:3273-3356.
    """

    WorkflowExecutionStarted = 0
    WorkflowExecutionCompleted = 1
    WorkflowExecutionFailed = 2
    WorkflowExecutionTimedOut = 3
    DecisionTaskScheduled = 4
    DecisionTaskStarted = 5
    DecisionTaskCompleted = 6
    DecisionTaskTimedOut = 7
    DecisionTaskFailed = 8
    ActivityTaskScheduled = 9
    ActivityTaskStarted = 10
    ActivityTaskCompleted = 11
    ActivityTaskFailed = 12
    ActivityTaskTimedOut = 13
    ActivityTaskCancelRequested = 14
    RequestCancelActivityTaskFailed = 15
    ActivityTaskCanceled = 16
    TimerStarted = 17
    TimerFired = 18
    CancelTimerFailed = 19
    TimerCanceled = 20
    WorkflowExecutionCancelRequested = 21
    WorkflowExecutionCanceled = 22
    RequestCancelExternalWorkflowExecutionInitiated = 23
    RequestCancelExternalWorkflowExecutionFailed = 24
    ExternalWorkflowExecutionCancelRequested = 25
    MarkerRecorded = 26
    WorkflowExecutionSignaled = 27
    WorkflowExecutionTerminated = 28
    WorkflowExecutionContinuedAsNew = 29
    StartChildWorkflowExecutionInitiated = 30
    StartChildWorkflowExecutionFailed = 31
    ChildWorkflowExecutionStarted = 32
    ChildWorkflowExecutionCompleted = 33
    ChildWorkflowExecutionFailed = 34
    ChildWorkflowExecutionCanceled = 35
    ChildWorkflowExecutionTimedOut = 36
    ChildWorkflowExecutionTerminated = 37
    SignalExternalWorkflowExecutionInitiated = 38
    SignalExternalWorkflowExecutionFailed = 39
    ExternalWorkflowExecutionSignaled = 40
    UpsertWorkflowSearchAttributes = 41


NUM_EVENT_TYPES = len(EventType)


class WorkflowState(enum.IntEnum):
    """Reference: common/persistence/dataManagerInterfaces.go:117-124."""

    Created = 0
    Running = 1
    Completed = 2
    Zombie = 3
    Void = 4
    Corrupted = 5


class CloseStatus(enum.IntEnum):
    """Reference: common/persistence/dataManagerInterfaces.go:127-135."""

    Nothing = 0  # "None" in Go; renamed to avoid the Python keyword
    Completed = 1
    Failed = 2
    Canceled = 3
    Terminated = 4
    ContinuedAsNew = 5
    TimedOut = 6


class TimeoutType(enum.IntEnum):
    """Activity/decision timeout flavors.

    Reference: common/types/shared.go (TimeoutType iota) and
    service/history/execution/timer_sequence.go:40-49.
    """

    StartToClose = 0
    ScheduleToStart = 1
    ScheduleToClose = 2
    Heartbeat = 3


class TransferTaskType(enum.IntEnum):
    """Reference: common/persistence/dataManagerInterfaces.go:149-162."""

    DecisionTask = 0
    ActivityTask = 1
    CloseExecution = 2
    CancelExecution = 3
    StartChildExecution = 4
    SignalExecution = 5
    RecordWorkflowStarted = 6
    ResetWorkflow = 7
    UpsertWorkflowSearchAttributes = 8
    RecordWorkflowClosed = 9
    RecordChildExecutionCompleted = 10
    ApplyParentClosePolicy = 11


class CrossClusterTaskType(enum.IntEnum):
    """Reference: common/persistence/dataManagerInterfaces.go:165-171."""

    StartChildExecution = 1
    CancelExecution = 2
    SignalExecution = 3
    RecordChildExecutionCompleted = 4
    ApplyParentClosePolicy = 5


class ReplicationTaskType(enum.IntEnum):
    """Reference: common/persistence/dataManagerInterfaces.go:174-178."""

    History = 0
    SyncActivity = 1
    FailoverMarker = 2


class TimerTaskType(enum.IntEnum):
    """Reference: common/persistence/dataManagerInterfaces.go:181-189."""

    DecisionTimeout = 0
    ActivityTimeout = 1
    UserTimer = 2
    WorkflowTimeout = 3
    DeleteHistoryEvent = 4
    ActivityRetryTimer = 5
    WorkflowBackoffTimer = 6


class WorkflowBackoffTimeoutType(enum.IntEnum):
    """Reference: common/persistence/dataManagerInterfaces.go:196-199."""

    Retry = 0
    Cron = 1


class ParentClosePolicy(enum.IntEnum):
    """Reference: common/types/shared.go (ParentClosePolicy iota)."""

    Abandon = 0
    RequestCancel = 1
    Terminate = 2


class ContinueAsNewInitiator(enum.IntEnum):
    """Reference: common/types/shared.go (ContinueAsNewInitiator iota)."""

    Decider = 0
    RetryPolicy = 1
    CronSchedule = 2


class DecisionType(enum.IntEnum):
    """Decisions emitted by workflow workers.

    Reference: common/types/shared.go (DecisionType iota).
    """

    ScheduleActivityTask = 0
    RequestCancelActivityTask = 1
    StartTimer = 2
    CompleteWorkflowExecution = 3
    FailWorkflowExecution = 4
    CancelTimer = 5
    CancelWorkflowExecution = 6
    RequestCancelExternalWorkflowExecution = 7
    RecordMarker = 8
    ContinueAsNewWorkflowExecution = 9
    StartChildWorkflowExecution = 10
    SignalExternalWorkflowExecution = 11
    UpsertWorkflowSearchAttributes = 12


# --- User/activity timer bookkeeping -----------------------------------------
# Reference: service/history/execution/timer_sequence.go:51-67

TIMER_TASK_STATUS_NONE = 0
TIMER_TASK_STATUS_CREATED = 1  # user timers

TIMER_TASK_STATUS_CREATED_START_TO_CLOSE = 1
TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_START = 2
TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_CLOSE = 4
TIMER_TASK_STATUS_CREATED_HEARTBEAT = 8

TIMER_TYPE_TO_STATUS_MASK = {
    TimeoutType.StartToClose: TIMER_TASK_STATUS_CREATED_START_TO_CLOSE,
    TimeoutType.ScheduleToStart: TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_START,
    TimeoutType.ScheduleToClose: TIMER_TASK_STATUS_CREATED_SCHEDULE_TO_CLOSE,
    TimeoutType.Heartbeat: TIMER_TASK_STATUS_CREATED_HEARTBEAT,
}

# Close events and the close status each one sets
# (mutable_state_builder.go:2561-2655,:2719-2733,:3225-3240,:3366-3382) —
# shared by the device transition kernel and task generator so the two can
# never enumerate different close sets.
CLOSE_EVENT_STATUS = (
    (EventType.WorkflowExecutionCompleted, CloseStatus.Completed),
    (EventType.WorkflowExecutionFailed, CloseStatus.Failed),
    (EventType.WorkflowExecutionTimedOut, CloseStatus.TimedOut),
    (EventType.WorkflowExecutionCanceled, CloseStatus.Canceled),
    (EventType.WorkflowExecutionTerminated, CloseStatus.Terminated),
    (EventType.WorkflowExecutionContinuedAsNew, CloseStatus.ContinuedAsNew),
)

# --- Sentinels ----------------------------------------------------------------
# Reference: common/constants.go:30-58

FIRST_EVENT_ID = 1
EMPTY_EVENT_ID = -23
EMPTY_VERSION = -24
END_EVENT_ID = (1 << 63) - 1
BUFFERED_EVENT_ID = -123
#: in-memory-only started marker for retrying activities whose started
#: event is flushed lazily at close (common/constants.go:43)
TRANSIENT_EVENT_ID = -124
EMPTY_UUID = "emptyUuid"

# Nanoseconds per second: event timestamps are unix nanos, timeouts are seconds
# (reference stores timestamps as UnixNano int64 and timeouts as int32 seconds).
NANOS_PER_SECOND = 1_000_000_000

# Failure reasons that are never retried regardless of retry policy.
# Reference: service/history/execution/retry.go:74-80 and
# common/constants.go (FailureReason*).
FAILURE_REASON_CANCEL_DETAILS_EXCEEDS_LIMIT = "CANCEL_DETAILS_EXCEEDS_LIMIT"
FAILURE_REASON_COMPLETE_RESULT_EXCEEDS_LIMIT = "COMPLETE_RESULT_EXCEEDS_LIMIT"
FAILURE_REASON_HEARTBEAT_EXCEEDS_LIMIT = "HEARTBEAT_EXCEEDS_LIMIT"
FAILURE_REASON_DECISION_BLOB_SIZE_EXCEEDS_LIMIT = "DECISION_BLOB_SIZE_EXCEEDS_LIMIT"

NON_RETRIABLE_SIZE_FAILURE_REASONS = frozenset(
    {
        FAILURE_REASON_CANCEL_DETAILS_EXCEEDS_LIMIT,
        FAILURE_REASON_COMPLETE_RESULT_EXCEEDS_LIMIT,
        FAILURE_REASON_HEARTBEAT_EXCEEDS_LIMIT,
        FAILURE_REASON_DECISION_BLOB_SIZE_EXCEEDS_LIMIT,
    }
)
