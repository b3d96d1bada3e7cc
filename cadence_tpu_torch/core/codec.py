"""Binary event-batch codec: the framework's wire/storage serialization.

Reference analog: the thriftrw/JSON payload serializer
(common/persistence/serialization/serializer.go:40,:272) that encodes event
batches for the history store. This codec defines a compact little-endian
binary layout that both the Python serializer/deserializer here and the C++
native packer (native/packer.cc) understand; the native packer decodes it
straight into the [W, E, L] lane tensors at host-feed rates (SURVEY.md §7
hard part 6).

Wire layout (version 1), little-endian throughout:

  history  := u32 n_batches, batch*
  batch    := u16 n_events, event*
  event    := i64 id, u8 type, i64 version, i64 timestamp, i64 task_id,
              u8 n_attrs, attr*
  attr     := u8 code, payload
  payload  := i64                      (numeric codes)
            | u16 len, bytes           (string codes: ACTIVITY_ID, TIMER_ID)

Only replay-relevant attributes are carried (state transitions never read
payload blobs; state_builder.go:132-646).
"""
from __future__ import annotations

import struct
from typing import List, Sequence

from .enums import EventType
from .events import HistoryBatch, HistoryEvent, RetryPolicy

CODEC_VERSION = 1

# attribute wire codes (mirrored in native/packer.cc — keep in lockstep)
A_EXEC_TIMEOUT = 1        # execution_start_to_close_timeout_seconds
A_TASK_TIMEOUT = 2        # task_start_to_close_timeout_seconds
A_BACKOFF = 3             # first_decision_task_backoff_seconds
A_ATTEMPT = 4             # attempt
A_EXPIRATION_TS = 5       # expiration_timestamp (nanos)
# code 6 reserved (was a bare has-parent flag; superseded by codes 21-24)
A_HAS_RETRY = 7           # 0/1 (kept alongside codes 25-28 for the lane path)
A_INITIATOR = 8           # ContinueAsNewInitiator; absent → none
A_SCHED_EVENT_ID = 9      # scheduled_event_id
A_STARTED_EVENT_ID = 10   # started_event_id
A_TIMEOUT_TYPE = 11
A_ACTIVITY_ID = 12        # string
A_S2S = 13                # schedule_to_start_timeout_seconds
A_S2C = 14                # schedule_to_close_timeout_seconds
A_STC = 15                # start_to_close_timeout_seconds
A_HEARTBEAT = 16          # heartbeat_timeout_seconds
A_RETRY_EXPIRATION = 17   # retry policy expiration_interval_seconds
A_TIMER_ID = 18           # string
A_START_TO_FIRE = 19      # start_to_fire_timeout_seconds
A_INITIATED_EVENT_ID = 20
# parent linkage + full retry policy (transport fidelity: child workflows
# and retrying activities must round-trip the codec with nothing lost)
A_PARENT_WORKFLOW_ID = 21   # string
A_PARENT_RUN_ID = 22        # string
A_PARENT_DOMAIN_ID = 23     # string
A_PARENT_INITIATED_ID = 24
A_RETRY_INIT_INTERVAL = 25
A_RETRY_COEFF_MILLI = 26    # backoff coefficient * 1000, integer
A_RETRY_MAX_INTERVAL = 27
A_RETRY_MAX_ATTEMPTS = 28
# routing/lineage strings (round 2): a standby rebuilt from replicated blobs
# must be able to DRIVE the workflow after failover — dispatch decisions and
# activities to the real task list, start children, deliver external
# signals/cancels, follow continue-as-new chains. The reference replicates
# full thrift event blobs so these always survive the wire
# (common/persistence/serialization/serializer.go); here they are explicit
# codes. Keep native/packer.cc in lockstep (it refuses unknown codes).
A_TASK_LIST = 29            # string
A_WORKFLOW_TYPE = 30        # string
A_CRON_SCHEDULE = 31        # string
A_FIRST_EXEC_RUN_ID = 32    # string
A_REQUEST_ID = 33           # string
A_TARGET_WORKFLOW_ID = 34   # string ("workflow_id" on initiated/started events)
A_TARGET_RUN_ID = 35        # string ("run_id")
A_TARGET_DOMAIN_ID = 36     # string ("domain_id")
A_SIGNAL_NAME = 37          # string
A_NEW_RUN_ID = 38           # string ("new_execution_run_id", ContinuedAsNew)
A_PARENT_CLOSE_POLICY = 39
A_CHILD_WF_ONLY = 40        # "child_workflow_only" on external cancel/signal
A_LAST_FAILURE_REASON = 41  # string; flushed transient ActivityTaskStarted

STRING_CODES = frozenset({A_ACTIVITY_ID, A_TIMER_ID, A_PARENT_WORKFLOW_ID,
                          A_PARENT_RUN_ID, A_PARENT_DOMAIN_ID,
                          A_TASK_LIST, A_WORKFLOW_TYPE, A_CRON_SCHEDULE,
                          A_FIRST_EXEC_RUN_ID, A_REQUEST_ID,
                          A_TARGET_WORKFLOW_ID, A_TARGET_RUN_ID,
                          A_TARGET_DOMAIN_ID, A_SIGNAL_NAME, A_NEW_RUN_ID,
                          A_LAST_FAILURE_REASON})

_EV_HEAD = struct.Struct("<qBqqqB")  # id, type, version, ts, task_id, n_attrs
_I64 = struct.Struct("<q")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")


def _event_wire_attrs(ev: HistoryEvent) -> List[tuple]:
    """The replay-relevant attributes of one event as (code, value) pairs."""
    et = ev.event_type
    g = ev.get
    out: List[tuple] = []

    def num(code: int, key: str) -> None:
        v = g(key, 0) or 0
        if v:
            out.append((code, int(v)))

    def retry_fields(retry: RetryPolicy) -> None:
        out.append((A_HAS_RETRY, 1))
        if retry.initial_interval_seconds:
            out.append((A_RETRY_INIT_INTERVAL, retry.initial_interval_seconds))
        if retry.backoff_coefficient:
            out.append((A_RETRY_COEFF_MILLI, round(retry.backoff_coefficient * 1000)))
        if retry.maximum_interval_seconds:
            out.append((A_RETRY_MAX_INTERVAL, retry.maximum_interval_seconds))
        if retry.maximum_attempts:
            out.append((A_RETRY_MAX_ATTEMPTS, retry.maximum_attempts))
        if retry.expiration_interval_seconds:
            out.append((A_RETRY_EXPIRATION, retry.expiration_interval_seconds))

    def string(code: int, key: str) -> None:
        v = g(key, "")
        if v:
            out.append((code, v))

    if et == EventType.WorkflowExecutionStarted:
        num(A_EXEC_TIMEOUT, "execution_start_to_close_timeout_seconds")
        num(A_TASK_TIMEOUT, "task_start_to_close_timeout_seconds")
        num(A_BACKOFF, "first_decision_task_backoff_seconds")
        num(A_ATTEMPT, "attempt")
        num(A_EXPIRATION_TS, "expiration_timestamp")
        string(A_TASK_LIST, "task_list")
        string(A_WORKFLOW_TYPE, "workflow_type")
        string(A_CRON_SCHEDULE, "cron_schedule")
        string(A_FIRST_EXEC_RUN_ID, "first_execution_run_id")
        if g("parent_workflow_id"):
            out.append((A_PARENT_WORKFLOW_ID, g("parent_workflow_id")))
            out.append((A_PARENT_RUN_ID, g("parent_run_id", "")))
            out.append((A_PARENT_DOMAIN_ID, g("parent_workflow_domain_id", "")))
            if g("parent_initiated_event_id") is not None:
                out.append((A_PARENT_INITIATED_ID, g("parent_initiated_event_id")))
        if g("retry_policy") is not None:
            retry_fields(g("retry_policy"))
        if g("initiator") is not None:
            out.append((A_INITIATOR, int(g("initiator"))))
    elif et == EventType.DecisionTaskScheduled:
        num(A_STC, "start_to_close_timeout_seconds")
        num(A_ATTEMPT, "attempt")
        string(A_TASK_LIST, "task_list")
    elif et in (EventType.DecisionTaskStarted, EventType.ActivityTaskStarted):
        num(A_SCHED_EVENT_ID, "scheduled_event_id")
        string(A_REQUEST_ID, "request_id")
        num(A_ATTEMPT, "attempt")
        string(A_LAST_FAILURE_REASON, "last_failure_reason")
    elif et == EventType.DecisionTaskCompleted:
        num(A_SCHED_EVENT_ID, "scheduled_event_id")
        num(A_STARTED_EVENT_ID, "started_event_id")
    elif et == EventType.DecisionTaskTimedOut:
        num(A_TIMEOUT_TYPE, "timeout_type")
    elif et == EventType.ActivityTaskScheduled:
        out.append((A_ACTIVITY_ID, g("activity_id", "")))
        num(A_S2S, "schedule_to_start_timeout_seconds")
        num(A_S2C, "schedule_to_close_timeout_seconds")
        num(A_STC, "start_to_close_timeout_seconds")
        num(A_HEARTBEAT, "heartbeat_timeout_seconds")
        string(A_TASK_LIST, "task_list")
        string(A_TARGET_DOMAIN_ID, "domain_id")
        retry: RetryPolicy = g("retry_policy")
        if retry is not None:
            retry_fields(retry)
    elif et in (EventType.ActivityTaskCompleted, EventType.ActivityTaskFailed,
                EventType.ActivityTaskTimedOut, EventType.ActivityTaskCanceled):
        num(A_SCHED_EVENT_ID, "scheduled_event_id")
    elif et == EventType.ActivityTaskCancelRequested:
        out.append((A_ACTIVITY_ID, g("activity_id", "")))
    elif et == EventType.TimerStarted:
        out.append((A_TIMER_ID, g("timer_id", "")))
        num(A_START_TO_FIRE, "start_to_fire_timeout_seconds")
    elif et in (EventType.TimerFired, EventType.TimerCanceled):
        out.append((A_TIMER_ID, g("timer_id", "")))
    elif et == EventType.StartChildWorkflowExecutionInitiated:
        string(A_TARGET_WORKFLOW_ID, "workflow_id")
        string(A_TARGET_DOMAIN_ID, "domain_id")
        string(A_WORKFLOW_TYPE, "workflow_type")
        string(A_TASK_LIST, "task_list")
        num(A_PARENT_CLOSE_POLICY, "parent_close_policy")
    elif et in (EventType.SignalExternalWorkflowExecutionInitiated,
                EventType.RequestCancelExternalWorkflowExecutionInitiated):
        string(A_TARGET_WORKFLOW_ID, "workflow_id")
        string(A_TARGET_RUN_ID, "run_id")
        string(A_TARGET_DOMAIN_ID, "domain_id")
        num(A_CHILD_WF_ONLY, "child_workflow_only")
        if et == EventType.SignalExternalWorkflowExecutionInitiated:
            string(A_SIGNAL_NAME, "signal_name")
    elif et == EventType.WorkflowExecutionSignaled:
        # signal name + request id must survive the WAL/replication
        # round-trip: replay rebuilds the signal dedup set from the event
        # (a redelivered request id after recovery must stay a no-op)
        string(A_SIGNAL_NAME, "signal_name")
        string(A_REQUEST_ID, "request_id")
    elif et == EventType.WorkflowExecutionContinuedAsNew:
        string(A_NEW_RUN_ID, "new_execution_run_id")
    elif et == EventType.ChildWorkflowExecutionStarted:
        num(A_INITIATED_EVENT_ID, "initiated_event_id")
        string(A_TARGET_RUN_ID, "run_id")
    elif et in (
        EventType.StartChildWorkflowExecutionFailed,
        EventType.ChildWorkflowExecutionCompleted,
        EventType.ChildWorkflowExecutionFailed,
        EventType.ChildWorkflowExecutionCanceled,
        EventType.ChildWorkflowExecutionTimedOut,
        EventType.ChildWorkflowExecutionTerminated,
        EventType.RequestCancelExternalWorkflowExecutionFailed,
        EventType.ExternalWorkflowExecutionCancelRequested,
        EventType.SignalExternalWorkflowExecutionFailed,
        EventType.ExternalWorkflowExecutionSignaled,
    ):
        num(A_INITIATED_EVENT_ID, "initiated_event_id")
    return out


def serialize_history(batches: Sequence[HistoryBatch]) -> bytes:
    """One workflow's batched history → wire bytes."""
    parts: List[bytes] = [_U32.pack(len(batches))]
    for batch in batches:
        parts.append(_U16.pack(len(batch.events)))
        for ev in batch.events:
            attrs = _event_wire_attrs(ev)
            parts.append(_EV_HEAD.pack(ev.id, int(ev.event_type), ev.version,
                                       ev.timestamp, ev.task_id, len(attrs)))
            for code, value in attrs:
                parts.append(bytes([code]))
                if code in STRING_CODES:
                    raw = value.encode("utf-8")
                    parts.append(_U16.pack(len(raw)))
                    parts.append(raw)
                else:
                    parts.append(_I64.pack(value))
    return b"".join(parts)


def serialize_corpus(histories: Sequence[Sequence[HistoryBatch]]) -> List[bytes]:
    return [serialize_history(h) for h in histories]


def deserialize_history(data: bytes, domain_id: str = "d", workflow_id: str = "w",
                        run_id: str = "r") -> List[HistoryBatch]:
    """Wire bytes → batches (numeric/string attrs only — the decode side of
    the codec, used by replication transport and tests)."""
    off = 0
    (n_batches,) = _U32.unpack_from(data, off)
    off += 4
    batches: List[HistoryBatch] = []
    for _ in range(n_batches):
        (n_events,) = _U16.unpack_from(data, off)
        off += 2
        events: List[HistoryEvent] = []
        for _ in range(n_events):
            eid, etype, version, ts, task_id, n_attrs = _EV_HEAD.unpack_from(data, off)
            off += _EV_HEAD.size
            attrs = {}
            for _ in range(n_attrs):
                code = data[off]
                off += 1
                if code in STRING_CODES:
                    (slen,) = _U16.unpack_from(data, off)
                    off += 2
                    sval = data[off:off + slen].decode("utf-8")
                    off += slen
                    attrs[_CODE_TO_KEY[code]] = sval
                else:
                    (v,) = _I64.unpack_from(data, off)
                    off += 8
                    attrs[_CODE_TO_KEY[code]] = v
            # reassemble the retry policy object the replayer consumes
            if attrs.pop("has_retry", 0):
                attrs["retry_policy"] = RetryPolicy(
                    initial_interval_seconds=attrs.pop("retry_initial_interval", 0),
                    backoff_coefficient=attrs.pop("retry_coeff_milli", 0) / 1000.0,
                    maximum_interval_seconds=attrs.pop("retry_maximum_interval", 0),
                    maximum_attempts=attrs.pop("retry_maximum_attempts", 0),
                    expiration_interval_seconds=attrs.pop(
                        "retry_expiration_interval_seconds", 0),
                )
            events.append(HistoryEvent(id=eid, event_type=EventType(etype),
                                       version=version, timestamp=ts,
                                       task_id=task_id, attrs=attrs))
        batches.append(HistoryBatch(domain_id=domain_id, workflow_id=workflow_id,
                                    run_id=run_id, events=events))
    return batches


_CODE_TO_KEY = {
    A_EXEC_TIMEOUT: "execution_start_to_close_timeout_seconds",
    A_TASK_TIMEOUT: "task_start_to_close_timeout_seconds",
    A_BACKOFF: "first_decision_task_backoff_seconds",
    A_ATTEMPT: "attempt",
    A_EXPIRATION_TS: "expiration_timestamp",
    A_HAS_RETRY: "has_retry",
    A_INITIATOR: "initiator",
    A_SCHED_EVENT_ID: "scheduled_event_id",
    A_STARTED_EVENT_ID: "started_event_id",
    A_TIMEOUT_TYPE: "timeout_type",
    A_ACTIVITY_ID: "activity_id",
    A_S2S: "schedule_to_start_timeout_seconds",
    A_S2C: "schedule_to_close_timeout_seconds",
    A_STC: "start_to_close_timeout_seconds",
    A_HEARTBEAT: "heartbeat_timeout_seconds",
    A_RETRY_EXPIRATION: "retry_expiration_interval_seconds",
    A_TIMER_ID: "timer_id",
    A_START_TO_FIRE: "start_to_fire_timeout_seconds",
    A_INITIATED_EVENT_ID: "initiated_event_id",
    A_PARENT_WORKFLOW_ID: "parent_workflow_id",
    A_PARENT_RUN_ID: "parent_run_id",
    A_PARENT_DOMAIN_ID: "parent_workflow_domain_id",
    A_PARENT_INITIATED_ID: "parent_initiated_event_id",
    A_RETRY_INIT_INTERVAL: "retry_initial_interval",
    A_RETRY_COEFF_MILLI: "retry_coeff_milli",
    A_RETRY_MAX_INTERVAL: "retry_maximum_interval",
    A_RETRY_MAX_ATTEMPTS: "retry_maximum_attempts",
    A_TASK_LIST: "task_list",
    A_WORKFLOW_TYPE: "workflow_type",
    A_CRON_SCHEDULE: "cron_schedule",
    A_FIRST_EXEC_RUN_ID: "first_execution_run_id",
    A_REQUEST_ID: "request_id",
    A_TARGET_WORKFLOW_ID: "workflow_id",
    A_TARGET_RUN_ID: "run_id",
    A_TARGET_DOMAIN_ID: "domain_id",
    A_SIGNAL_NAME: "signal_name",
    A_NEW_RUN_ID: "new_execution_run_id",
    A_PARENT_CLOSE_POLICY: "parent_close_policy",
    A_CHILD_WF_ONLY: "child_workflow_only",
    A_LAST_FAILURE_REASON: "last_failure_reason",
}
