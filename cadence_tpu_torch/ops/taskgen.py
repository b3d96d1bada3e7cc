"""Transfer and timer task generation during replay: the plain version.

Replay in the reference does not only rebuild state: it also derives the
transfer and timer tasks the engine must process
(mutable_state_task_generator.go, called from the state_builder switch and
at the end of each ApplyEvents batch). Tasks are appended to
fixed-capacity per-workflow logs ([W, T] tensors plus counts) that the host
drains in bulk; their numeric fields equal the oracle's GeneratedTask
streams (string fields such as task lists resolve on the host from event
IDs).

This module is the JAX package's ops/taskgen.py transliterated line for
line into torch ops on [W] and [W, T] tensors, every event type's tasks
computed for all workflows and blended by masks. It is what the CPU runs
and what the tests hold against the JAX package; on the GPU the same
emission is a compile-time variant of kernel A (csrc/taskgen.cuh, through
ops/replay.replay_tasks_scan), which this module is held against.

Replay is the passive-side path: a close event emits exactly one
CloseExecution transfer task and the retention-driven DeleteHistoryEvent
timer (task_generator.go:180-185, :249-255); active-side cross-cluster
fan-out belongs to the host engine.

The task logs of workflows whose error code is set are undefined beyond the
point of failure (the reference aborts the whole replay transaction there).
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple, Tuple

import torch

from ..core.enums import (
    CLOSE_EVENT_STATUS,
    EMPTY_EVENT_ID,
    NANOS_PER_SECOND,
    TIMER_TASK_STATUS_CREATED,
    TIMER_TYPE_TO_STATUS_MASK,
    EventType,
    TimeoutType,
    TimerTaskType,
    TransferTaskType,
    WorkflowBackoffTimeoutType,
)
from ..device import resolve_device
from .encode import (
    FLAG_VH_ONLY,
    LANE_A0,
    LANE_BATCH_LAST,
    LANE_EVENT_ID,
    LANE_EVENT_TYPE,
    LANE_FLAGS,
    LANE_TIMESTAMP,
    LANE_VERSION,
)
from .state import ReplayState
from .transitions import _scatter as _w  # the same masked one-hot write rule

_I64 = torch.int64
_DAY_NANOS = 24 * 3600 * NANOS_PER_SECOND
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


class TaskLog(NamedTuple):
    """Per-workflow task emission logs (append-only, capacity-capped)."""

    tr_type: torch.Tensor      # [W, Tt] i64 TransferTaskType
    tr_version: torch.Tensor   # [W, Tt] i64
    tr_event_id: torch.Tensor  # [W, Tt] i64 (schedule/initiated id; 0 if n/a)
    tr_count: torch.Tensor     # [W] i64
    tm_type: torch.Tensor      # [W, Tm] i64 TimerTaskType
    tm_version: torch.Tensor   # [W, Tm] i64
    tm_vis: torch.Tensor       # [W, Tm] i64 visibility timestamp nanos
    tm_event_id: torch.Tensor  # [W, Tm] i64
    tm_timeout_type: torch.Tensor  # [W, Tm] i64
    tm_attempt: torch.Tensor   # [W, Tm] i64
    tm_count: torch.Tensor     # [W] i64
    overflow: torch.Tensor     # [W] bool: a log filled up (reported, not silent)


def field_spec(name: str, W: int, Tt: int, Tm: int):
    """(dtype, shape) of TaskLog field `name` for W workflows and logs of
    Tt transfer and Tm timer entries."""
    if name == "overflow":
        return torch.bool, (W,)
    if name.endswith("count"):
        return _I64, (W,)
    return _I64, (W, Tm if name.startswith("tm_") else Tt)


def init_task_log(num_workflows: int, max_transfer: int, max_timer: int,
                  device=None) -> TaskLog:
    """Empty logs for W workflows on `device` (None: the card)."""
    W = num_workflows
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=_I64, device=device)

    return TaskLog(
        tr_type=z(W, max_transfer), tr_version=z(W, max_transfer),
        tr_event_id=z(W, max_transfer), tr_count=z(W),
        tm_type=z(W, max_timer), tm_version=z(W, max_timer),
        tm_vis=z(W, max_timer), tm_event_id=z(W, max_timer),
        tm_timeout_type=z(W, max_timer), tm_attempt=z(W, max_timer),
        tm_count=z(W), overflow=torch.zeros((W,), dtype=torch.bool, device=device),
    )


def retention_nanos(retention_days: int) -> int:
    """retention_days in nanoseconds; raises OverflowError, as the JAX
    package does, when that does not fit in int64."""
    nanos = int(retention_days) * _DAY_NANOS
    if not _INT64_MIN <= nanos <= _INT64_MAX:
        raise OverflowError(f"retention of {retention_days} days does not fit in int64 nanos")
    return nanos


def _emit(count, overflow, cap, mask):
    full = count >= cap
    do = mask & ~full
    onehot = (torch.arange(cap, device=count.device)[None, :] == count[:, None]) & do[:, None]
    return onehot, count + do.to(_I64), overflow | (mask & full)


def emit_transfer(log: TaskLog, mask, ttype, version, event_id) -> TaskLog:
    onehot, count, overflow = _emit(log.tr_count, log.overflow, log.tr_type.shape[1], mask)
    return log._replace(
        tr_type=_w(log.tr_type, onehot, ttype),
        tr_version=_w(log.tr_version, onehot, version),
        tr_event_id=_w(log.tr_event_id, onehot, event_id),
        tr_count=count, overflow=overflow,
    )


def emit_timer(log: TaskLog, mask, ttype, version, vis, event_id,
               timeout_type, attempt) -> TaskLog:
    onehot, count, overflow = _emit(log.tm_count, log.overflow, log.tm_type.shape[1], mask)
    return log._replace(
        tm_type=_w(log.tm_type, onehot, ttype),
        tm_version=_w(log.tm_version, onehot, version),
        tm_vis=_w(log.tm_vis, onehot, vis),
        tm_event_id=_w(log.tm_event_id, onehot, event_id),
        tm_timeout_type=_w(log.tm_timeout_type, onehot, timeout_type),
        tm_attempt=_w(log.tm_attempt, onehot, attempt),
        tm_count=count, overflow=overflow,
    )


def _lex_min3(valid, ts, eid, ttype):
    """Lexicographic argmin over (ts, event_id, timer_type) among valid slots.

    Mirrors TimerSequenceIDs.Less (timer_sequence.go:459-493). Returns
    (found [W], sel [W, K] one-hot of the winning slot). Invalid slots
    enter each minimum as 1 << 62, so a valid candidate whose key lies
    above that selects nothing, though `found` holds."""
    big = torch.tensor(1 << 62, dtype=_I64, device=ts.device)
    found = valid.any(dim=1)
    t1 = torch.where(valid, ts, big)
    min_ts = t1.min(dim=1).values
    m1 = valid & (t1 == min_ts[:, None])
    e1 = torch.where(m1, eid, big)
    min_e = e1.min(dim=1).values
    m2 = m1 & (e1 == min_e[:, None])
    y1 = torch.where(m2, ttype, big)
    min_y = y1.min(dim=1).values
    m3 = m2 & (y1 == min_y[:, None])
    # ties fully broken by (ts, eid, type); keep the first slot
    K = valid.shape[1]
    ar = torch.arange(K, device=ts.device)
    first = torch.where(m3, ar[None, :], torch.full_like(ar, K)[None, :]).min(dim=1).values
    sel = (ar[None, :] == first[:, None]) & found[:, None]
    return found, sel


def _masked_sum(sel, values):
    return torch.where(sel, values, torch.zeros_like(values)).sum(dim=1)


def batch_end_timer_tasks(s: ReplayState, log: TaskLog,
                          mask) -> Tuple[ReplayState, TaskLog]:
    """GenerateActivityTimerTasks + GenerateUserTimerTasks at batch end
    (state_builder.go:634-640; timer_sequence.go CreateNext*Timer)."""
    act = s.activities
    W, K = act.occ.shape
    empty = act.started_id == EMPTY_EVENT_ID

    # four candidate timers per activity (timer_sequence.go:219-254)
    cand_valid = torch.cat([
        act.occ,                                  # schedule-to-close
        act.occ & empty,                          # schedule-to-start
        act.occ & ~empty,                         # start-to-close
        act.occ & ~empty & (act.heartbeat > 0),   # heartbeat
    ], dim=1)
    cand_ts = torch.cat([
        act.scheduled_time + act.sched_to_close * NANOS_PER_SECOND,
        act.scheduled_time + act.sched_to_start * NANOS_PER_SECOND,
        act.started_time + act.start_to_close * NANOS_PER_SECOND,
        torch.maximum(act.started_time, act.last_heartbeat) + act.heartbeat * NANOS_PER_SECOND,
    ], dim=1)
    cand_eid = act.schedule_id.repeat(1, 4)
    type_codes = [TimeoutType.ScheduleToClose, TimeoutType.ScheduleToStart,
                  TimeoutType.StartToClose, TimeoutType.Heartbeat]
    dev = act.occ.device
    cand_type = torch.cat([torch.full((W, K), int(t), dtype=_I64, device=dev)
                           for t in type_codes], dim=1)
    cand_bit = torch.cat([torch.full((W, K), TIMER_TYPE_TO_STATUS_MASK[t], dtype=torch.int32,
                                     device=dev) for t in type_codes], dim=1)
    cand_created = (act.timer_status.repeat(1, 4) & cand_bit) > 0

    found, sel = _lex_min3(cand_valid & mask[:, None], cand_ts, cand_eid, cand_type)
    # only create when the first (minimum) timer is not yet created
    # (CreateNextActivityTimer returns early otherwise, :171-174)
    fresh = found & ~(sel & cand_created).any(dim=1)
    sel = sel & fresh[:, None]
    sel_ts = _masked_sum(sel, cand_ts)
    sel_eid = _masked_sum(sel, cand_eid)
    sel_type = _masked_sum(sel, cand_type)
    sel_attempt = _masked_sum(sel, act.attempt.repeat(1, 4))
    # fold the 4 quadrants back onto table slots to set the created bit
    slot_sel = sel[:, 0:K] | sel[:, K:2 * K] | sel[:, 2 * K:3 * K] | sel[:, 3 * K:]
    bit = _masked_sum(sel, cand_bit).to(torch.int32)
    act = replace(act, timer_status=torch.where(slot_sel, act.timer_status | bit[:, None],
                                                act.timer_status))
    log = emit_timer(log, fresh, int(TimerTaskType.ActivityTimeout), s.current_version,
                     sel_ts, sel_eid, sel_type, sel_attempt)

    # user timers (timer_sequence.go:127-160): a single candidate per timer
    tmr = s.timers
    created = tmr.task_status == TIMER_TASK_STATUS_CREATED
    found, sel = _lex_min3(tmr.occ & mask[:, None], tmr.expiry_time, tmr.started_id,
                           torch.zeros_like(tmr.started_id))
    fresh = found & ~(sel & created).any(dim=1)
    sel = sel & fresh[:, None]
    sel_ts = _masked_sum(sel, tmr.expiry_time)
    sel_eid = _masked_sum(sel, tmr.started_id)
    tmr = replace(tmr, task_status=torch.where(
        sel, torch.tensor(TIMER_TASK_STATUS_CREATED, dtype=torch.int32, device=dev),
        tmr.task_status))
    log = emit_timer(log, fresh, int(TimerTaskType.UserTimer), s.current_version, sel_ts,
                     sel_eid, torch.zeros_like(sel_eid), torch.zeros_like(sel_eid))
    return replace(s, activities=act, timers=tmr), log


def step_tasks(s_new: ReplayState, ev: torch.Tensor, log: TaskLog,
               retention_days: int) -> Tuple[ReplayState, TaskLog]:
    """Emit the tasks generated by applying `ev` (post-step state s_new)."""
    ev_id = ev[:, LANE_EVENT_ID]
    etype = ev[:, LANE_EVENT_TYPE]
    ev_version = ev[:, LANE_VERSION]
    ts = ev[:, LANE_TIMESTAMP]
    batch_last = ev[:, LANE_BATCH_LAST]
    a = [ev[:, LANE_A0 + i] for i in range(8)]
    zero = torch.zeros_like(ev_id)

    # VH-only events (non-current-branch persists) generate no tasks: the
    # reference persists them without running the task generator
    # (ndc/transaction_manager.go passive persists)
    vh_only = (ev[:, LANE_FLAGS] & FLAG_VH_ONLY) != 0
    ok = (ev_id > 0) & (s_new.error == 0) & ~vh_only

    def m(t: EventType):
        return ok & (etype == int(t))

    # --- WorkflowExecutionStarted (state_builder.go:158-177)
    m_started = m(EventType.WorkflowExecutionStarted)
    log = emit_transfer(log, m_started, int(TransferTaskType.RecordWorkflowStarted),
                        ev_version, zero)
    backoff = a[2] * NANOS_PER_SECOND
    wf_timeout_ts = ts + s_new.workflow_timeout * NANOS_PER_SECOND + backoff
    cap = (a[3] > 0) & (s_new.expiration_time != 0) & (wf_timeout_ts > s_new.expiration_time)
    wf_timeout_ts = torch.where(cap, s_new.expiration_time, wf_timeout_ts)
    log = emit_timer(log, m_started, int(TimerTaskType.WorkflowTimeout), ev_version,
                     wf_timeout_ts, zero, zero, zero)
    m_backoff = m_started & (a[2] > 0)
    # initiator lane: -1 none → Cron; RetryPolicy → Retry (task_generator.go:271-288)
    backoff_type = torch.where(a[7] == 1, int(WorkflowBackoffTimeoutType.Retry),
                               int(WorkflowBackoffTimeoutType.Cron))
    log = emit_timer(log, m_backoff, int(TimerTaskType.WorkflowBackoffTimer), ev_version,
                     ts + backoff, zero, backoff_type, zero)

    # --- DecisionTask transfer on schedule and on transient schedule
    # (state_builder.go:204-208, :250-259, :272-281; task_generator.go:315-350;
    # no schedule-to-start timer on the replay path). A schedule-to-start
    # timeout creates no transient decision, so no dispatch task either.
    m_dsched = m(EventType.DecisionTaskScheduled)
    m_dtimeout = m(EventType.DecisionTaskTimedOut)
    m_dfail = (m(EventType.DecisionTaskFailed)
               | (m_dtimeout & (a[0] != int(TimeoutType.ScheduleToStart))))
    log = emit_transfer(log, m_dsched | m_dfail, int(TransferTaskType.DecisionTask),
                        s_new.decision_version, s_new.decision_schedule_id)

    # --- DecisionTaskStarted → start-to-close timeout timer
    # (task_generator.go:352-388)
    m_dstart = m(EventType.DecisionTaskStarted)
    log = emit_timer(log, m_dstart, int(TimerTaskType.DecisionTimeout), s_new.decision_version,
                     s_new.decision_started_ts + s_new.decision_timeout * NANOS_PER_SECOND,
                     s_new.decision_schedule_id,
                     torch.full_like(ev_id, int(TimeoutType.StartToClose)),
                     s_new.decision_attempt)

    # --- ActivityTaskScheduled → ActivityTask transfer (task_generator.go:390-428)
    log = emit_transfer(log, m(EventType.ActivityTaskScheduled),
                        int(TransferTaskType.ActivityTask), ev_version, ev_id)
    # --- StartChildWorkflowExecutionInitiated (task_generator.go:451-498)
    log = emit_transfer(log, m(EventType.StartChildWorkflowExecutionInitiated),
                        int(TransferTaskType.StartChildExecution), ev_version, ev_id)
    # --- external cancel / signal initiated (task_generator.go:500-600)
    log = emit_transfer(log, m(EventType.RequestCancelExternalWorkflowExecutionInitiated),
                        int(TransferTaskType.CancelExecution), ev_version, ev_id)
    log = emit_transfer(log, m(EventType.SignalExternalWorkflowExecutionInitiated),
                        int(TransferTaskType.SignalExecution), ev_version, ev_id)
    # --- UpsertWorkflowSearchAttributes (task_generator.go:602-612)
    log = emit_transfer(log, m(EventType.UpsertWorkflowSearchAttributes),
                        int(TransferTaskType.UpsertWorkflowSearchAttributes),
                        s_new.current_version, zero)

    # --- close events: CloseExecution transfer + retention deletion timer
    # (task_generator.go:168-258, passive path)
    m_close = torch.zeros_like(ok)
    for et, _status in CLOSE_EVENT_STATUS:
        m_close = m_close | m(et)
    log = emit_transfer(log, m_close, int(TransferTaskType.CloseExecution), ev_version, zero)
    log = emit_timer(log, m_close, int(TimerTaskType.DeleteHistoryEvent), ev_version,
                     ts + retention_nanos(retention_days), zero, zero, zero)

    # --- batch end: activity and user timer tasks
    m_end = ok & (batch_last == 1)
    return batch_end_timer_tasks(s_new, log, m_end)
