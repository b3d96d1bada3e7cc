"""Workflow shadowing: replay recorded histories against CURRENT decider
code and flag nondeterminism.

Reference: service/worker/shadower — before deploying new workflow code,
shadow it: re-run the decider over production histories and verify it
would make the SAME decisions the recorded history shows. A mismatch
means the new code would break replay determinism for in-flight
workflows (the SDK's nondeterminism error, caught pre-deploy).

The check walks a history decision-by-decision: at every completed
decision, the decider sees exactly the prefix the real worker saw (up to
and including its DecisionTaskStarted) and its output is compared
against the decision-originated events the transaction actually
recorded.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..core.enums import DecisionType, EventType
from ..core.events import HistoryEvent

#: DecisionType → the event type its acceptance records, plus the attr
#: carrying the user-visible identity to compare (None = type-only)
_DECISION_EVENT = {
    DecisionType.ScheduleActivityTask:
        (EventType.ActivityTaskScheduled, "activity_id"),
    DecisionType.StartTimer: (EventType.TimerStarted, "timer_id"),
    DecisionType.CancelTimer: (EventType.TimerCanceled, "timer_id"),
    DecisionType.CompleteWorkflowExecution:
        (EventType.WorkflowExecutionCompleted, None),
    DecisionType.FailWorkflowExecution:
        (EventType.WorkflowExecutionFailed, None),
    DecisionType.CancelWorkflowExecution:
        (EventType.WorkflowExecutionCanceled, None),
    DecisionType.ContinueAsNewWorkflowExecution:
        (EventType.WorkflowExecutionContinuedAsNew, None),
    DecisionType.StartChildWorkflowExecution:
        (EventType.StartChildWorkflowExecutionInitiated, "workflow_id"),
    DecisionType.RequestCancelExternalWorkflowExecution:
        (EventType.RequestCancelExternalWorkflowExecutionInitiated,
         "workflow_id"),
    DecisionType.SignalExternalWorkflowExecution:
        (EventType.SignalExternalWorkflowExecutionInitiated, "signal_name"),
    DecisionType.RecordMarker: (EventType.MarkerRecorded, "marker_name"),
    DecisionType.UpsertWorkflowSearchAttributes:
        (EventType.UpsertWorkflowSearchAttributes, None),
    DecisionType.RequestCancelActivityTask:
        (EventType.ActivityTaskCancelRequested, "activity_id"),
}

#: event types a decision transaction records for its decisions (the
#: comparison universe; engine-originated events like timeouts are not
#: decider output and are skipped)
_DECISION_ORIGINATED = {ev for ev, _ in _DECISION_EVENT.values()}
# the engine records RequestCancelActivityTaskFailed (unknown/finished
# activity id) INSTEAD of ActivityTaskCancelRequested for the same
# decision — part of the comparison universe and an accepted outcome
_DECISION_ORIGINATED.add(EventType.RequestCancelActivityTaskFailed)
#: event type → identity attribute (inverse of _DECISION_EVENT's values)
_EVENT_ID_ATTR = {ev: attr for ev, attr in _DECISION_EVENT.values()}
_EVENT_ID_ATTR[EventType.RequestCancelActivityTaskFailed] = "activity_id"

#: close decisions the ENGINE may legitimately translate into a
#: continue-as-new (cron schedules continue a completed run, retry
#: policies continue a failed one — history_engine's cron/retry arms);
#: a recorded ContinuedAsNew therefore MATCHES these, and only these
_CLOSE_TRANSLATABLE = {EventType.WorkflowExecutionCompleted,
                       EventType.WorkflowExecutionFailed,
                       EventType.WorkflowExecutionContinuedAsNew}


def _entry_matches(expected: Tuple, recorded: Tuple) -> bool:
    if expected == recorded:
        return True
    exp_type, exp_id = expected
    rec_type, rec_id = recorded
    if (rec_type == EventType.WorkflowExecutionContinuedAsNew
            and exp_type in _CLOSE_TRANSLATABLE):
        return True
    # a cancel decision for an unknown/finished activity legitimately
    # records the Failed variant (history_engine RequestCancelActivityTask)
    return (exp_type == EventType.ActivityTaskCancelRequested
            and rec_type == EventType.RequestCancelActivityTaskFailed
            and exp_id == rec_id)


def _signatures_match(expected: List[Tuple], recorded: List[Tuple]) -> bool:
    return (len(expected) == len(recorded)
            and all(_entry_matches(e, r)
                    for e, r in zip(expected, recorded)))


@dataclass
class ShadowMismatch:
    decision_index: int          # which completed decision (0-based)
    at_event_id: int             # the DecisionTaskCompleted event id
    expected: List[Tuple]        # (event_type, identity) the decider produced
    recorded: List[Tuple]        # (event_type, identity) history shows


@dataclass
class ShadowResult:
    workflow_id: str
    run_id: str
    decisions_checked: int = 0
    mismatches: List[ShadowMismatch] = field(default_factory=list)
    #: the decider RAISED mid-replay (itself a replay break worth
    #: surfacing; the sweep isolates it per run, never aborts)
    error: str = ""

    @property
    def ok(self) -> bool:
        return not self.mismatches and not self.error


def _signature(decisions) -> List[Tuple]:
    out = []
    for d in decisions:
        mapping = _DECISION_EVENT.get(DecisionType(d.decision_type))
        if mapping is None:
            out.append((int(d.decision_type), None))
            continue
        event_type, id_attr = mapping
        identity = d.attrs.get(id_attr) if id_attr else None
        out.append((event_type, identity))
    return out


def _recorded_signature(events: List[HistoryEvent], start: int) -> List[Tuple]:
    """Decision-originated events of the batch following the completed
    decision (they share its transaction, so they run until the next
    non-originated event or the next decision cycle)."""
    out = []
    for ev in events[start:]:
        if ev.event_type == EventType.DecisionTaskScheduled:
            break
        if ev.event_type not in _DECISION_ORIGINATED:
            continue
        id_attr = _EVENT_ID_ATTR.get(ev.event_type)
        identity = ev.get(id_attr) if id_attr else None
        out.append((ev.event_type, identity))
    return out


def shadow_history(events: List[HistoryEvent], decider,
                   workflow_id: str = "", run_id: str = "") -> ShadowResult:
    """Replay one recorded history against `decider`; every completed
    decision's output must match what the history recorded."""
    import bisect

    result = ShadowResult(workflow_id=workflow_id, run_id=run_id)
    ids = [e.id for e in events]  # ascending: one slice per decision, O(n)
    for i, ev in enumerate(events):
        if ev.event_type != EventType.DecisionTaskCompleted:
            continue
        started_id = ev.get("started_event_id", ev.id - 1)
        # the worker saw the prefix up to and including its Started event
        prefix = events[:bisect.bisect_right(ids, started_id)]
        expected = _signature(decider.decide(prefix))
        recorded = _recorded_signature(events, i + 1)
        if not _signatures_match(expected, recorded):
            result.mismatches.append(ShadowMismatch(
                decision_index=result.decisions_checked,
                at_event_id=ev.id, expected=expected, recorded=recorded))
        result.decisions_checked += 1
    return result


class WorkflowShadower:
    """Shadow live cluster histories (the shadower service's scan loop):
    pull each run's recorded history and replay it against the decider
    registered for its workflow type."""

    def __init__(self, stores) -> None:
        self.stores = stores

    def shadow_workflow(self, domain_id: str, workflow_id: str,
                        run_id: Optional[str], decider) -> ShadowResult:
        if run_id is None:
            run_id = self.stores.execution.get_current_run_id(domain_id,
                                                              workflow_id)
        events = self.stores.history.read_events(domain_id, workflow_id,
                                                 run_id)
        return shadow_history(events, decider, workflow_id, run_id)

    def shadow_query(self, domain_id: str, query: str,
                     deciders_by_type) -> List[ShadowResult]:
        """Shadow every visibility match whose workflow type has a decider
        (shadower.WorkflowParams' query + sampling surface)."""
        results = []
        for rec in self.stores.visibility.query(domain_id, query):
            decider = deciders_by_type.get(rec.workflow_type)
            if decider is None:
                continue
            try:
                results.append(self.shadow_workflow(
                    domain_id, rec.workflow_id, rec.run_id, decider))
            except Exception as exc:
                # a decider crashing on an old history IS a replay break;
                # isolate it per run (batcher/failovermanager posture)
                results.append(ShadowResult(
                    workflow_id=rec.workflow_id, run_id=rec.run_id,
                    error=f"{type(exc).__name__}: {exc}"))
        return results
