"""One lockstep transition step: apply event e to all W workflows.

A frozen copy of the port's plain step (cadence_tpu_torch/ops/transitions.py),
with its imports pointed at this package: every event type's update is
computed for all workflows and blended by event-type masks; pending-map
operations are masked insert/delete/update on fixed-capacity [W, K]
tables. The benchmark judges the port's kernels against it and never
imports the port from here.

Error semantics: conditions that make the reference return an error set a
sticky per-workflow error code and freeze that workflow's row; healthy rows
are unaffected. See state.py ErrorCode.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .enums import (
    CLOSE_EVENT_STATUS,
    EMPTY_EVENT_ID,
    EMPTY_VERSION,
    NANOS_PER_SECOND,
    CloseStatus,
    EventType,
    TimeoutType,
    WorkflowState,
)
from .layout import (
    FLAG_RUN_RESET,
    FLAG_VH_ONLY,
    LANE_A0,
    LANE_BATCH_FIRST,
    LANE_BATCH_LAST,
    LANE_BRANCH,
    LANE_EVENT_ID,
    LANE_EVENT_TYPE,
    LANE_FLAGS,
    LANE_PARENT,
    LANE_TASK_ID,
    LANE_TIMESTAMP,
    LANE_VERSION,
    PAD,
)
from .state import ErrorCode, ReplayState, reset_rows

_I64 = torch.int64
_I32 = torch.int32


def _sel(mask, new, old):
    if not torch.is_tensor(new):
        new = torch.tensor(new, dtype=old.dtype, device=old.device)
    return torch.where(mask, new.to(old.dtype), old)


def _set_err(error, cond, code):
    """Record `code` where cond holds and no earlier error exists (sticky)."""
    return torch.where((error == 0) & cond,
                       torch.tensor(code, dtype=error.dtype, device=error.device),
                       error)


# ---------------------------------------------------------------------------
# Masked table primitives (the Go-map analog on dense [W, K] tables)
# ---------------------------------------------------------------------------


def table_insert_slot(occ: torch.Tensor, mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First-free-slot selection. Returns (onehot [W,K], new_occ, overflow [W])."""
    full = occ.all(dim=1)
    do = mask & ~full
    slot = occ.to(torch.uint8).argmin(dim=1)  # first False (argmin takes no bool)
    K = occ.shape[1]
    ar = torch.arange(K, device=occ.device)
    onehot = (ar[None, :] == slot[:, None]) & do[:, None]
    return onehot, occ | onehot, mask & full


def table_match(occ: torch.Tensor, key_field: torch.Tensor, key: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equality lookup. Returns (sel [W,K] — EVERY matching slot under mask,
    missing [W] = masked rows with no match)."""
    eq = occ & (key_field == key[:, None])
    found = eq.any(dim=1)
    return eq & mask[:, None], mask & ~found


def _scatter(field: torch.Tensor, onehot: torch.Tensor, value) -> torch.Tensor:
    if not torch.is_tensor(value):
        value = torch.tensor(value, dtype=field.dtype, device=field.device)
    if value.dim() == 1:
        value = value[:, None]
    return torch.where(onehot, value.to(field.dtype), field)


# ---------------------------------------------------------------------------
# Workflow state/close-status transition guard (workflowExecutionInfo.go)
# ---------------------------------------------------------------------------


def state_transition_valid(cur_state, cur_close, new_state, new_close):
    """All four arguments broadcast as tensors (or Python ints)."""
    WS, CS = WorkflowState, CloseStatus
    cur_state = torch.as_tensor(cur_state)
    cur_close = torch.as_tensor(cur_close)
    new_state = torch.as_tensor(new_state, device=cur_state.device)
    new_close = torch.as_tensor(new_close, device=cur_state.device)
    none = int(CS.Nothing)
    to_crz_ok = new_close == none
    from_created = torch.where(
        (new_state == WS.Created) | (new_state == WS.Running)
        | (new_state == WS.Zombie),
        to_crz_ok,
        (new_state == WS.Completed)
        & ((new_close == CS.Terminated) | (new_close == CS.TimedOut)
           | (new_close == CS.ContinuedAsNew)),
    )
    false = torch.zeros_like(to_crz_ok)
    from_running = torch.where(
        new_state == WS.Created,
        false,
        torch.where(
            (new_state == WS.Running) | (new_state == WS.Zombie),
            to_crz_ok,
            (new_state == WS.Completed) & (new_close != none),
        ),
    )
    from_completed = (new_state == WS.Completed) & (new_close == cur_close)
    from_zombie = torch.where(
        (new_state == WS.Created) | (new_state == WS.Running),
        new_close == none,
        ((new_state == WS.Completed) | (new_state == WS.Zombie))
        & (new_close != none),
    )
    return torch.where(
        cur_state == WS.Void,
        torch.ones_like(from_created),
        torch.where(
            cur_state == WS.Created,
            from_created,
            torch.where(
                cur_state == WS.Running,
                from_running,
                torch.where(
                    cur_state == WS.Completed,
                    from_completed,
                    torch.where(cur_state == WS.Zombie, from_zombie,
                                torch.zeros_like(from_created)),
                ),
            ),
        ),
    )


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _gather_branch(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [W, B, ...] → the rows of branch idx [W, ...]."""
    index = idx.to(_I64).reshape((-1, 1) + (1,) * (arr.dim() - 2))
    index = index.expand((arr.shape[0], 1) + tuple(arr.shape[2:]))
    return torch.gather(arr, 1, index).squeeze(1)


def _last_item(values: torch.Tensor, count: torch.Tensor, empty: int):
    """Value at slot count-1 (0 if that slot is past Kv), or `empty` when
    the branch holds no items."""
    Kv = values.shape[1]
    last_idx = torch.clamp(count - 1, min=0)
    onehot = torch.arange(Kv, device=values.device)[None, :] == last_idx[:, None]
    picked = torch.where(onehot, values, torch.zeros_like(values)).sum(dim=1)
    return torch.where(count > 0, picked, torch.full_like(picked, empty)), onehot


def step(s: ReplayState, ev: torch.Tensor) -> ReplayState:
    """Apply one event (lanes [W, L] int64) to all workflows. Returns a new
    state; `s` is not modified."""
    dev = ev.device
    ev_id = ev[:, LANE_EVENT_ID]
    etype = ev[:, LANE_EVENT_TYPE]
    ev_version = ev[:, LANE_VERSION]
    ts = ev[:, LANE_TIMESTAMP]
    task_id = ev[:, LANE_TASK_ID]
    batch_first = ev[:, LANE_BATCH_FIRST]
    batch_last = ev[:, LANE_BATCH_LAST]
    branch = ev[:, LANE_BRANCH].to(_I32)
    parent = ev[:, LANE_PARENT].to(_I32)
    flags = ev[:, LANE_FLAGS]
    a = [ev[:, LANE_A0 + i] for i in range(8)]

    # --- 0. continue-as-new run boundary (sticky errors survive the reset)
    do_reset = (ev_id > 0) & (s.error == 0) & ((flags & FLAG_RUN_RESET) != 0)
    if bool(do_reset.any()):
        s = reset_rows(s, do_reset)

    live = (ev_id > 0) & (s.error == 0)
    vh_only = (flags & FLAG_VH_ONLY) != 0
    error = s.error

    # --- 1. per-branch version-history bookkeeping with fork-inherit
    B = s.vh_event_ids.shape[1]
    Kv = s.vh_event_ids.shape[2]
    branch_over = live & (branch >= B)
    error = _set_err(error, branch_over, ErrorCode.BRANCH_OVERFLOW)
    live = live & ~branch_over
    b = torch.clamp(branch, 0, B - 1)
    p = torch.clamp(parent, 0, B - 1)

    b_ids = _gather_branch(s.vh_event_ids, b)        # [W, Kv]
    b_versions = _gather_branch(s.vh_versions, b)    # [W, Kv]
    b_count = _gather_branch(s.vh_count, b)          # [W]
    p_ids = _gather_branch(s.vh_event_ids, p)
    p_versions = _gather_branch(s.vh_versions, p)
    p_count = _gather_branch(s.vh_count, p)

    inherit = live & (b_count == 0) & (p != b)
    lca_eid = ev_id - 1
    slot = torch.arange(Kv, device=dev)[None, :]
    prev_eid = torch.cat(
        [torch.zeros((p_ids.shape[0], 1), dtype=p_ids.dtype, device=dev),
         p_ids[:, :-1]], dim=1)
    keep = (slot < p_count[:, None]) & (prev_eid < lca_eid[:, None])
    bad_fork = inherit & ((p_count == 0) | (lca_eid < 1))
    error = _set_err(error, bad_fork, ErrorCode.BAD_FORK)
    inherit = inherit & ~bad_fork
    pad = torch.full_like(p_ids, int(PAD))
    inh_ids = torch.where(keep, torch.minimum(p_ids, lca_eid[:, None]), pad)
    inh_versions = torch.where(keep, p_versions, pad)
    inh_count = keep.sum(dim=1).to(s.vh_count.dtype)
    b_ids = torch.where(inherit[:, None], inh_ids, b_ids)
    b_versions = torch.where(inherit[:, None], inh_versions, b_versions)
    b_count = torch.where(inherit, inh_count, b_count)
    live = live & ~bad_fork

    has_items = b_count > 0
    vh_last_version, vh_last_onehot = _last_item(b_versions, b_count, EMPTY_VERSION)
    vh_last_event, _ = _last_item(b_ids, b_count, EMPTY_EVENT_ID)

    # current branch's last version, from the state before this step
    cur_versions = _gather_branch(s.vh_versions, s.current_branch)
    cur_count = _gather_branch(s.vh_count, s.current_branch)
    cur_last_version, _ = _last_item(cur_versions, cur_count, EMPTY_VERSION)

    # --- 2. version history AddOrUpdateItem(event.ID, event.Version)
    vh_order_bad = live & has_items & (
        (ev_version < vh_last_version) | (ev_id <= vh_last_event))
    error = _set_err(error, vh_order_bad, ErrorCode.VERSION_HISTORY_ORDER)
    vh_ok = live & ~vh_order_bad
    append = vh_ok & (~has_items | (ev_version > vh_last_version))
    vh_overflow = append & (b_count >= Kv)
    error = _set_err(error, vh_overflow, ErrorCode.VERSION_HISTORY_OVERFLOW)
    append_ok = append & ~vh_overflow
    update_last = vh_ok & has_items & (ev_version == vh_last_version)
    onehot_append = (slot == b_count[:, None]) & append_ok[:, None]
    onehot_update = vh_last_onehot & update_last[:, None]
    write = onehot_append | onehot_update
    b_ids = torch.where(write, ev_id[:, None], b_ids)
    b_versions = torch.where(onehot_append, ev_version[:, None], b_versions)
    b_count = b_count + append_ok.to(b_count.dtype)

    touched = live & (inherit | append_ok | update_last)
    bsel = (torch.arange(B, device=dev)[None, :] == b[:, None]) & touched[:, None]
    vh_event_ids = torch.where(bsel[:, :, None], b_ids[:, None, :], s.vh_event_ids)
    vh_versions = torch.where(bsel[:, :, None], b_versions[:, None, :], s.vh_versions)
    vh_count = torch.where(bsel, b_count[:, None], s.vh_count)

    # --- 3. current-branch arbitration
    ok = vh_ok & ~vh_overflow
    switch = ok & (b != s.current_branch) & (ev_version > cur_last_version)
    current_branch = torch.where(switch, b, s.current_branch)

    # --- 4. UpdateCurrentVersion(version, force=True)
    completed = s.state == WorkflowState.Completed
    current_version = _sel(live & ~vh_only,
                           torch.where(completed, cur_last_version, ev_version),
                           s.current_version)

    ok = ok & ~vh_only
    last_event_task_id = _sel(ok, task_id, s.last_event_task_id)

    def m(t: EventType) -> torch.Tensor:
        return ok & (etype == int(t))

    error = _set_err(error, ok & ((etype < 0)
                                  | (etype > int(EventType.UpsertWorkflowSearchAttributes))),
                     ErrorCode.UNKNOWN_EVENT_TYPE)

    # WorkflowExecutionStarted
    m_started = m(EventType.WorkflowExecutionStarted)
    started_bad = m_started & ~state_transition_valid(
        s.state, s.close_status, int(WorkflowState.Created), int(CloseStatus.Nothing))
    error = _set_err(error, started_bad, ErrorCode.INVALID_STATE_TRANSITION)
    m_started = m_started & ~started_bad
    bad_initiator = m_started & (a[2] > 0) & ((a[7] == 0) | (a[7] >= 3))
    error = _set_err(error, bad_initiator, ErrorCode.INVALID_BACKOFF_INITIATOR)
    m_started = m_started & ~bad_initiator

    workflow_timeout = _sel(m_started, a[0], s.workflow_timeout)
    decision_sts_timeout = _sel(m_started, a[1], s.decision_sts_timeout)
    start_timestamp = _sel(m_started, ts, s.start_timestamp)
    workflow_attempt = _sel(m_started, a[3], s.workflow_attempt)
    expiration_time = _sel(m_started & (a[4] != 0), a[4], s.expiration_time)
    has_parent = _sel(m_started, a[5] != 0, s.has_parent)
    state_v = _sel(m_started, int(WorkflowState.Created), s.state)
    close_v = _sel(m_started, int(CloseStatus.Nothing), s.close_status)
    last_processed = _sel(m_started, EMPTY_EVENT_ID, s.last_processed_event)
    last_first = _sel(m_started, ev_id, s.last_first_event_id)

    # Decision state machine
    d_version = _sel(m_started, EMPTY_VERSION, s.decision_version)
    d_sched = _sel(m_started, EMPTY_EVENT_ID, s.decision_schedule_id)
    d_started = _sel(m_started, EMPTY_EVENT_ID, s.decision_started_id)
    d_attempt = s.decision_attempt
    d_timeout = _sel(m_started, 0, s.decision_timeout)
    d_sched_ts = s.decision_scheduled_ts
    d_started_ts = s.decision_started_ts
    d_orig_ts = s.decision_original_scheduled_ts

    m_dsched = m(EventType.DecisionTaskScheduled)
    dsched_trans = m_dsched & (state_v != WorkflowState.Zombie)
    dsched_bad = dsched_trans & ~state_transition_valid(
        state_v, close_v, int(WorkflowState.Running), int(CloseStatus.Nothing))
    error = _set_err(error, dsched_bad, ErrorCode.INVALID_STATE_TRANSITION)
    m_dsched = m_dsched & ~dsched_bad
    dsched_trans = dsched_trans & ~dsched_bad
    state_v = _sel(dsched_trans, int(WorkflowState.Running), state_v)
    close_v = _sel(dsched_trans, int(CloseStatus.Nothing), close_v)
    d_version = _sel(m_dsched, ev_version, d_version)
    d_sched = _sel(m_dsched, ev_id, d_sched)
    d_started = _sel(m_dsched, EMPTY_EVENT_ID, d_started)
    d_attempt = _sel(m_dsched, a[1], d_attempt)
    d_timeout = _sel(m_dsched, a[0], d_timeout)
    d_sched_ts = _sel(m_dsched, ts, d_sched_ts)
    d_started_ts = _sel(m_dsched, 0, d_started_ts)
    d_orig_ts = _sel(m_dsched, ts, d_orig_ts)

    m_dstart = m(EventType.DecisionTaskStarted)
    dstart_missing = m_dstart & (d_sched != a[0])
    error = _set_err(error, dstart_missing, ErrorCode.MISSING_DECISION)
    m_dstart = m_dstart & ~dstart_missing
    d_version = _sel(m_dstart, ev_version, d_version)
    d_started = _sel(m_dstart, ev_id, d_started)
    d_attempt = _sel(m_dstart, 0, d_attempt)
    d_started_ts = _sel(m_dstart, ts, d_started_ts)

    m_dcomp = m(EventType.DecisionTaskCompleted)
    d_version = _sel(m_dcomp, EMPTY_VERSION, d_version)
    d_sched = _sel(m_dcomp, EMPTY_EVENT_ID, d_sched)
    d_started = _sel(m_dcomp, EMPTY_EVENT_ID, d_started)
    d_attempt = _sel(m_dcomp, 0, d_attempt)
    d_timeout = _sel(m_dcomp, 0, d_timeout)
    d_sched_ts = _sel(m_dcomp, 0, d_sched_ts)
    d_started_ts = _sel(m_dcomp, 0, d_started_ts)
    last_processed = _sel(m_dcomp, a[1], last_processed)

    m_dtimeout = m(EventType.DecisionTaskTimedOut)
    m_noinc = m_dtimeout & (a[0] == int(TimeoutType.ScheduleToStart))
    m_dfail = (m(EventType.DecisionTaskFailed) | m_dtimeout) & ~m_noinc
    attempt_after_fail = d_attempt + 1
    d_version = _sel(m_dfail, current_version, d_version)
    d_version = _sel(m_noinc, EMPTY_VERSION, d_version)
    d_sched = _sel(m_dfail, s.next_event_id, d_sched)
    d_sched = _sel(m_noinc, EMPTY_EVENT_ID, d_sched)
    d_started = _sel(m_dfail | m_noinc, EMPTY_EVENT_ID, d_started)
    d_attempt = _sel(m_dfail, attempt_after_fail, d_attempt)
    d_attempt = _sel(m_noinc, 0, d_attempt)
    d_timeout = _sel(m_dfail, decision_sts_timeout, d_timeout)
    d_timeout = _sel(m_noinc, 0, d_timeout)
    d_sched_ts = _sel(m_dfail, ts, d_sched_ts)
    d_sched_ts = _sel(m_noinc, 0, d_sched_ts)
    d_started_ts = _sel(m_dfail | m_noinc, 0, d_started_ts)
    d_orig_ts = _sel(m_dfail | m_noinc, 0, d_orig_ts)

    # Activities
    act = s.activities
    zeros = torch.zeros_like(ev_id)
    empty_id = torch.full_like(ev_id, EMPTY_EVENT_ID)
    m_asched = m(EventType.ActivityTaskScheduled)
    onehot, act_occ, act_over = table_insert_slot(act.occ, m_asched)
    error = _set_err(error, act_over, ErrorCode.TABLE_OVERFLOW)
    act = type(act)(
        occ=act_occ,
        schedule_id=_scatter(act.schedule_id, onehot, ev_id),
        started_id=_scatter(act.started_id, onehot, empty_id),
        version=_scatter(act.version, onehot, ev_version),
        activity_key=_scatter(act.activity_key, onehot, a[0]),
        scheduled_time=_scatter(act.scheduled_time, onehot, ts),
        started_time=_scatter(act.started_time, onehot, zeros),
        last_heartbeat=_scatter(act.last_heartbeat, onehot, zeros),
        sched_to_start=_scatter(act.sched_to_start, onehot, a[1]),
        sched_to_close=_scatter(act.sched_to_close, onehot, a[2]),
        start_to_close=_scatter(act.start_to_close, onehot, a[3]),
        heartbeat=_scatter(act.heartbeat, onehot, a[4]),
        cancel_requested=_scatter(act.cancel_requested, onehot, False),
        cancel_request_id=_scatter(act.cancel_request_id, onehot, empty_id),
        attempt=_scatter(act.attempt, onehot, zeros),
        timer_status=_scatter(act.timer_status, onehot, 0),
        has_retry=_scatter(act.has_retry, onehot, a[5] != 0),
        batch_id=_scatter(act.batch_id, onehot, batch_first),
    )

    m_astart = m(EventType.ActivityTaskStarted)
    sel_slots, missing = table_match(act.occ, act.schedule_id, a[0], m_astart)
    error = _set_err(error, missing, ErrorCode.MISSING_ACTIVITY)
    act.version = _scatter(act.version, sel_slots, ev_version)
    act.started_id = _scatter(act.started_id, sel_slots, ev_id)
    act.started_time = _scatter(act.started_time, sel_slots, ts)
    act.last_heartbeat = _scatter(act.last_heartbeat, sel_slots, ts)

    m_aclose = (m(EventType.ActivityTaskCompleted) | m(EventType.ActivityTaskFailed)
                | m(EventType.ActivityTaskTimedOut) | m(EventType.ActivityTaskCanceled))
    sel_slots, missing = table_match(act.occ, act.schedule_id, a[0], m_aclose)
    error = _set_err(error, missing, ErrorCode.MISSING_ACTIVITY)
    act.occ = act.occ & ~sel_slots

    m_acreq = m(EventType.ActivityTaskCancelRequested)
    sel_slots, _ = table_match(act.occ, act.activity_key, a[0], m_acreq)
    act.version = _scatter(act.version, sel_slots, ev_version)
    act.cancel_requested = _scatter(act.cancel_requested, sel_slots, True)
    act.cancel_request_id = _scatter(act.cancel_request_id, sel_slots, ev_id)

    # User timers
    tmr = s.timers
    m_tstart = m(EventType.TimerStarted)
    onehot, tmr_occ, tmr_over = table_insert_slot(tmr.occ, m_tstart)
    error = _set_err(error, tmr_over, ErrorCode.TABLE_OVERFLOW)
    tmr = type(tmr)(
        occ=tmr_occ,
        timer_key=_scatter(tmr.timer_key, onehot, a[0]),
        started_id=_scatter(tmr.started_id, onehot, ev_id),
        expiry_time=_scatter(tmr.expiry_time, onehot, ts + a[1] * NANOS_PER_SECOND),
        task_status=_scatter(tmr.task_status, onehot, 0),
        version=_scatter(tmr.version, onehot, ev_version),
    )
    m_tdel = m(EventType.TimerFired) | m(EventType.TimerCanceled)
    sel_slots, missing = table_match(tmr.occ, tmr.timer_key, a[0], m_tdel)
    error = _set_err(error, missing, ErrorCode.MISSING_TIMER)
    tmr.occ = tmr.occ & ~sel_slots

    # Child workflows
    ch = s.children
    m_cinit = m(EventType.StartChildWorkflowExecutionInitiated)
    onehot, ch_occ, ch_over = table_insert_slot(ch.occ, m_cinit)
    error = _set_err(error, ch_over, ErrorCode.TABLE_OVERFLOW)
    ch = type(ch)(
        occ=ch_occ,
        initiated_id=_scatter(ch.initiated_id, onehot, ev_id),
        started_id=_scatter(ch.started_id, onehot, empty_id),
        version=_scatter(ch.version, onehot, ev_version),
        batch_id=_scatter(ch.batch_id, onehot, batch_first),
    )
    m_cstart = m(EventType.ChildWorkflowExecutionStarted)
    sel_slots, missing = table_match(ch.occ, ch.initiated_id, a[0], m_cstart)
    error = _set_err(error, missing, ErrorCode.MISSING_CHILD)
    ch.started_id = _scatter(ch.started_id, sel_slots, ev_id)
    m_cdel = (m(EventType.StartChildWorkflowExecutionFailed)
              | m(EventType.ChildWorkflowExecutionCompleted)
              | m(EventType.ChildWorkflowExecutionFailed)
              | m(EventType.ChildWorkflowExecutionCanceled)
              | m(EventType.ChildWorkflowExecutionTimedOut)
              | m(EventType.ChildWorkflowExecutionTerminated))
    sel_slots, missing = table_match(ch.occ, ch.initiated_id, a[0], m_cdel)
    error = _set_err(error, missing, ErrorCode.MISSING_CHILD)
    ch.occ = ch.occ & ~sel_slots

    # External request-cancels / signals
    def initiated(table, m_init, m_del, missing_code):
        onehot, occ, over = table_insert_slot(table.occ, m_init)
        err = _set_err(error, over, ErrorCode.TABLE_OVERFLOW)
        t = type(table)(
            occ=occ,
            initiated_id=_scatter(table.initiated_id, onehot, ev_id),
            version=_scatter(table.version, onehot, ev_version),
            batch_id=_scatter(table.batch_id, onehot, batch_first),
        )
        sel, miss = table_match(t.occ, t.initiated_id, a[0], m_del)
        err = _set_err(err, miss, missing_code)
        t.occ = t.occ & ~sel
        return t, err

    rc, error = initiated(
        s.cancels, m(EventType.RequestCancelExternalWorkflowExecutionInitiated),
        m(EventType.RequestCancelExternalWorkflowExecutionFailed)
        | m(EventType.ExternalWorkflowExecutionCancelRequested),
        ErrorCode.MISSING_REQUEST_CANCEL)
    sg, error = initiated(
        s.signals, m(EventType.SignalExternalWorkflowExecutionInitiated),
        m(EventType.SignalExternalWorkflowExecutionFailed)
        | m(EventType.ExternalWorkflowExecutionSignaled),
        ErrorCode.MISSING_SIGNAL)

    # Workflow-level scalars
    signal_count = s.signal_count + m(EventType.WorkflowExecutionSignaled).to(_I64)
    cancel_requested = s.cancel_requested | m(EventType.WorkflowExecutionCancelRequested)

    m_close = torch.zeros_like(live)
    close_val = torch.zeros_like(s.close_status)
    for et, cs in CLOSE_EVENT_STATUS:
        mm = m(et)
        m_close = m_close | mm
        close_val = _sel(mm, int(cs), close_val)
    close_bad = m_close & ~state_transition_valid(
        state_v, close_v, int(WorkflowState.Completed), close_val)
    error = _set_err(error, close_bad, ErrorCode.INVALID_STATE_TRANSITION)
    m_close = m_close & ~close_bad
    state_v = _sel(m_close, int(WorkflowState.Completed), state_v)
    close_v = _sel(m_close, close_val, close_v)
    completion_batch = _sel(m_close, batch_first, s.completion_event_batch_id)

    # Batch-end bookkeeping, only when this event applied cleanly
    end_ok = ok & (batch_last == 1) & (error == 0)
    last_first = _sel(end_ok, batch_first, last_first)
    next_event_id = _sel(end_ok, ev_id + 1, s.next_event_id)

    return ReplayState(
        state=state_v,
        close_status=close_v,
        cancel_requested=cancel_requested,
        last_first_event_id=last_first,
        next_event_id=next_event_id,
        last_processed_event=last_processed,
        signal_count=signal_count,
        decision_version=d_version,
        decision_schedule_id=d_sched,
        decision_started_id=d_started,
        decision_attempt=d_attempt,
        decision_timeout=d_timeout,
        decision_scheduled_ts=d_sched_ts,
        decision_started_ts=d_started_ts,
        decision_original_scheduled_ts=d_orig_ts,
        workflow_timeout=workflow_timeout,
        decision_sts_timeout=decision_sts_timeout,
        start_timestamp=start_timestamp,
        completion_event_batch_id=completion_batch,
        last_event_task_id=last_event_task_id,
        workflow_attempt=workflow_attempt,
        expiration_time=expiration_time,
        has_parent=has_parent,
        current_version=current_version,
        vh_event_ids=vh_event_ids,
        vh_versions=vh_versions,
        vh_count=vh_count,
        current_branch=current_branch,
        activities=act,
        timers=tmr,
        children=ch,
        cancels=rc,
        signals=sg,
        error=error,
    )
