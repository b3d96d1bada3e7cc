"""Decision attribute validation (service/history/decision/checker.go).

Every decision in a RespondDecisionTaskCompleted batch is validated BEFORE
any of it applies; a bad decision fails the whole decision task with a
typed cause (decision/handler.go failDecision causes, e.g.
BAD_SCHEDULE_ACTIVITY_ATTRIBUTES) so the worker re-decides — malformed
attributes never surface as replay-transaction crashes.

Activity timeout deduction follows checker.go:222-302 exactly:
- negative timeouts are invalid;
- every timeout caps at the workflow execution timeout;
- with a valid schedule-to-close, missing schedule-to-start /
  start-to-close default to it;
- else both schedule-to-start and start-to-close must be valid, and
  schedule-to-close becomes their (capped) sum;
- else there is not enough information: invalid.
The deduction MUTATES the decision's attributes (the reference fills the
defaults into the scheduled event).
"""
from __future__ import annotations

from typing import Optional

from ..core.enums import DecisionType


class BadDecisionAttributes(Exception):
    """Carries the decision-task failure cause."""

    def __init__(self, cause: str, message: str) -> None:
        super().__init__(f"{cause}: {message}")
        self.cause = cause


def _require(cond: bool, cause: str, message: str) -> None:
    if not cond:
        raise BadDecisionAttributes(cause, message)


def _validate_activity(a: dict, wf_timeout: int) -> None:
    cause = "BAD_SCHEDULE_ACTIVITY_ATTRIBUTES"
    _require(bool(a.get("activity_id")), cause,
             "ActivityId is not set on decision")
    s2c = int(a.get("schedule_to_close_timeout_seconds", 0) or 0)
    s2s = int(a.get("schedule_to_start_timeout_seconds", 0) or 0)
    stc = int(a.get("start_to_close_timeout_seconds", 0) or 0)
    hb = int(a.get("heartbeat_timeout_seconds", 0) or 0)
    _require(min(s2c, s2s, stc, hb) >= 0, cause,
             "a valid timeout may not be negative")
    # cap at the workflow timeout (checker.go:276-281)
    s2c, s2s = min(s2c, wf_timeout), min(s2s, wf_timeout)
    stc, hb = min(stc, wf_timeout), min(hb, wf_timeout)
    # deduction (checker.go:283-302)
    if s2c > 0:
        s2s = s2s or s2c
        stc = stc or s2c
    elif s2s > 0 and stc > 0:
        s2c = min(s2s + stc, wf_timeout)
    else:
        _require(False, cause,
                 "a valid ScheduleToCloseTimeout is not set on decision")
    a["schedule_to_close_timeout_seconds"] = s2c
    a["schedule_to_start_timeout_seconds"] = s2s
    a["start_to_close_timeout_seconds"] = stc
    a["heartbeat_timeout_seconds"] = hb
    retry = a.get("retry_policy")
    if retry is not None:
        _require(retry.initial_interval_seconds >= 0
                 and retry.backoff_coefficient >= 1
                 and retry.maximum_attempts >= 0, cause,
                 "invalid retry policy")


def _validate_timer(a: dict) -> None:
    cause = "BAD_START_TIMER_ATTRIBUTES"
    _require(bool(a.get("timer_id")), cause, "TimerId is not set on decision")
    _require(int(a.get("start_to_fire_timeout_seconds", 0) or 0) > 0, cause,
             "a valid StartToFireTimeoutSeconds is not set on decision")


def validate_decision(decision, wf_timeout: int,
                      blob_size_limit: int = 0) -> None:
    """Raise BadDecisionAttributes when the decision is malformed; may
    fill deduced defaults into decision.attrs (the reference mutates the
    attributes the same way). `blob_size_limit` (when > 0) bounds every
    bytes-valued attribute — the decision checker's blob-size arm
    (decision/checker.go via common.CheckEventBlobSizeLimit)."""
    a = decision.attrs
    dt = decision.decision_type
    if blob_size_limit:
        for field, v in a.items():
            if isinstance(v, (bytes, bytearray)) and len(v) > blob_size_limit:
                _require(False, "BAD_BINARY",
                         f"{field} payload {len(v)}B exceeds the "
                         f"{blob_size_limit}B blob limit")
    if dt == DecisionType.ScheduleActivityTask:
        _validate_activity(a, wf_timeout)
    elif dt == DecisionType.StartTimer:
        _validate_timer(a)
    elif dt == DecisionType.CancelTimer:
        _require(bool(a.get("timer_id")), "BAD_CANCEL_TIMER_ATTRIBUTES",
                 "TimerId is not set on decision")
    elif dt == DecisionType.RequestCancelActivityTask:
        _require(bool(a.get("activity_id")),
                 "BAD_REQUEST_CANCEL_ACTIVITY_ATTRIBUTES",
                 "ActivityId is not set on decision")
    elif dt == DecisionType.StartChildWorkflowExecution:
        cause = "BAD_START_CHILD_EXECUTION_ATTRIBUTES"
        _require(bool(a.get("workflow_id")), cause,
                 "WorkflowId is not set on decision")
        _require(bool(a.get("workflow_type")), cause,
                 "WorkflowType is not set on decision")
    elif dt == DecisionType.SignalExternalWorkflowExecution:
        cause = "BAD_SIGNAL_WORKFLOW_EXECUTION_ATTRIBUTES"
        _require(bool(a.get("workflow_id")), cause,
                 "Execution is not set on decision")
        _require(bool(a.get("signal_name")), cause,
                 "SignalName is not set on decision")
    elif dt == DecisionType.RequestCancelExternalWorkflowExecution:
        _require(bool(a.get("workflow_id")),
                 "BAD_REQUEST_CANCEL_EXTERNAL_WORKFLOW_EXECUTION_ATTRIBUTES",
                 "WorkflowId is not set on decision")
    # Complete/Fail/Cancel/ContinueAsNew/RecordMarker/Upsert carry free-form
    # or optional payloads; nothing structural to reject here
