"""The enumerations and sentinels the plain replay reads: a frozen copy of
the port's core/enums.py (EventType, WorkflowState, CloseStatus,
TimeoutType, the close statuses and the sentinel ids), so that the
reference imports nothing of the program it judges.

The integer values are the lane values of the packed event tensors.
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



CLOSE_EVENT_STATUS = (
    (EventType.WorkflowExecutionCompleted, CloseStatus.Completed),
    (EventType.WorkflowExecutionFailed, CloseStatus.Failed),
    (EventType.WorkflowExecutionTimedOut, CloseStatus.TimedOut),
    (EventType.WorkflowExecutionCanceled, CloseStatus.Canceled),
    (EventType.WorkflowExecutionTerminated, CloseStatus.Terminated),
    (EventType.WorkflowExecutionContinuedAsNew, CloseStatus.ContinuedAsNew),
)

FIRST_EVENT_ID = 1
EMPTY_EVENT_ID = -23
EMPTY_VERSION = -24
NANOS_PER_SECOND = 1_000_000_000
