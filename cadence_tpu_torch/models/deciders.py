"""Workload definitions: the framework's "model families".

These are executable workflow definitions mirroring the reference's canary
and bench workloads (canary/echo.go, canary/signal.go, canary/timeout.go,
canary/concurrentExec.go, bench/load/basic/stressWorkflow.go): a decider is
a function from visible history to the next decisions — exactly the
contract a workflow worker fulfills over PollForDecisionTask.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..core.enums import DecisionType, EventType
from ..core.events import HistoryEvent
from ..engine.history_engine import Decision


def _count(history: List[HistoryEvent], *types: EventType) -> int:
    return sum(1 for e in history if e.event_type in types)


def _activity(activity_id: str, task_list: str, timeout: int = 60) -> Decision:
    return Decision(DecisionType.ScheduleActivityTask, dict(
        activity_id=activity_id, task_list=task_list,
        schedule_to_start_timeout_seconds=timeout,
        schedule_to_close_timeout_seconds=2 * timeout,
        start_to_close_timeout_seconds=timeout,
        heartbeat_timeout_seconds=0,
    ))


def _complete() -> Decision:
    return Decision(DecisionType.CompleteWorkflowExecution)


@dataclass
class ChainedActivityDecider:
    """bench basic stress workflow: a chain of sequential activities
    (bench/load/basic/stressWorkflow.go chainSequence)."""

    task_list: str
    chain_length: int = 3

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        done = _count(history, EventType.ActivityTaskCompleted)
        pending = _count(history, EventType.ActivityTaskScheduled) - _count(
            history, EventType.ActivityTaskCompleted,
            EventType.ActivityTaskFailed, EventType.ActivityTaskTimedOut,
            EventType.ActivityTaskCanceled)
        if pending > 0:
            return []
        if done >= self.chain_length:
            return [_complete()]
        return [_activity(f"chain-{done}", self.task_list)]


@dataclass
class EchoDecider:
    """canary echo: one activity, then complete."""

    task_list: str

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        if _count(history, EventType.ActivityTaskCompleted) >= 1:
            return [_complete()]
        if _count(history, EventType.ActivityTaskScheduled) >= 1:
            return []
        return [_activity("echo", self.task_list)]


@dataclass
class ResilientEchoDecider:
    """echo under fault injection: RESCHEDULES the activity when an
    attempt times out (a lost worker respond surfaces as
    ActivityTaskTimedOut) — the shape a production workflow takes in a
    lossy cluster, and what the concurrency/fault property tests drive."""

    task_list: str

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        if _count(history, EventType.ActivityTaskCompleted) >= 1:
            return [_complete()]
        live = _count(history, EventType.ActivityTaskScheduled) - (
            _count(history, EventType.ActivityTaskTimedOut)
            + _count(history, EventType.ActivityTaskFailed)
            + _count(history, EventType.ActivityTaskCanceled))
        if live > 0:
            return []
        return [_activity("echo", self.task_list)]


@dataclass
class SignalDecider:
    """canary signal: wait for N signals, then complete."""

    expected_signals: int = 3

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        got = _count(history, EventType.WorkflowExecutionSignaled)
        if got >= self.expected_signals:
            return [_complete()]
        return []


@dataclass
class TimerDecider:
    """canary timeout: start a timer; complete when it fires."""

    fire_seconds: int = 5

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        if _count(history, EventType.TimerFired) >= 1:
            return [_complete()]
        if _count(history, EventType.TimerStarted) >= 1:
            return []
        return [Decision(DecisionType.StartTimer, dict(
            timer_id="t-0", start_to_fire_timeout_seconds=self.fire_seconds))]


@dataclass
class ConcurrentActivityDecider:
    """canary concurrentExec: a wide batch of parallel activities, then
    complete when all finish."""

    task_list: str
    width: int = 4

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        scheduled = _count(history, EventType.ActivityTaskScheduled)
        closed = _count(history, EventType.ActivityTaskCompleted,
                        EventType.ActivityTaskFailed,
                        EventType.ActivityTaskTimedOut)
        if scheduled == 0:
            return [_activity(f"conc-{i}", self.task_list)
                    for i in range(self.width)]
        if closed >= self.width:
            return [_complete()]
        return []


@dataclass
class ChildWorkflowDecider:
    """parent workflow: launch a child, complete when the child closes."""

    child_workflow_id: str

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        if _count(history, EventType.ChildWorkflowExecutionCompleted,
                  EventType.ChildWorkflowExecutionFailed,
                  EventType.ChildWorkflowExecutionTimedOut,
                  EventType.ChildWorkflowExecutionTerminated,
                  EventType.ChildWorkflowExecutionCanceled) >= 1:
            return [_complete()]
        if _count(history, EventType.StartChildWorkflowExecutionInitiated) >= 1:
            return []
        return [Decision(DecisionType.StartChildWorkflowExecution, dict(
            workflow_id=self.child_workflow_id, workflow_type="child-type"))]


@dataclass
class RetryActivityDecider:
    """canary retry: one activity carrying a retry policy; complete when it
    finally succeeds, fail the workflow if it exhausts its attempts."""

    task_list: str
    initial_interval: int = 1
    backoff_coefficient: float = 2.0
    maximum_attempts: int = 3

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        from ..core.events import RetryPolicy
        if _count(history, EventType.ActivityTaskCompleted) >= 1:
            return [_complete()]
        if _count(history, EventType.ActivityTaskFailed,
                  EventType.ActivityTaskTimedOut) >= 1:
            return [Decision(DecisionType.FailWorkflowExecution,
                             dict(reason="activity retries exhausted"))]
        if _count(history, EventType.ActivityTaskScheduled) >= 1:
            return []
        d = _activity("flaky", self.task_list)
        d.attrs["retry_policy"] = RetryPolicy(
            initial_interval_seconds=self.initial_interval,
            backoff_coefficient=self.backoff_coefficient,
            maximum_interval_seconds=60,
            maximum_attempts=self.maximum_attempts,
        )
        return [d]


@dataclass
class CompleteDecider:
    """cron body: complete on the first decision (canary cron.go runs)."""

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        return [_complete()]


@dataclass
class FailDecider:
    """workflow-retry body: fail on the first decision."""

    reason: str = "wf-boom"

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        return [Decision(DecisionType.FailWorkflowExecution,
                         dict(reason=self.reason))]


@dataclass
class CancellationDecider:
    """canary cancellation: on cancel request, cancel the workflow."""

    task_list: str

    def decide(self, history: List[HistoryEvent]) -> List[Decision]:
        if _count(history, EventType.WorkflowExecutionCancelRequested) >= 1:
            return [Decision(DecisionType.CancelWorkflowExecution)]
        if _count(history, EventType.ActivityTaskScheduled) == 0:
            return [_activity("long-op", self.task_list, timeout=3600)]
        return []
