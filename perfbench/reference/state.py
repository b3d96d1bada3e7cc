"""Dense replay state: a frozen copy of the port's ops/state.py (the
state's dataclasses, `init_state`, `layout_of`, `reset_rows`), so that the
reference builds its own state and imports nothing of the program.

Every per-workflow field is a tensor over the workflow axis W:

- scalars:         [W]        (execution info + decision state + version)
- pending tables:  [W, K]     (activities, timers, children, cancels, signals)
- version history: [W, B, Kv] (event id / version item pairs) + [W, B] counts

Capacities K are fixed per layout (PayloadLayout); overflow sets the
per-workflow error code instead of truncating. The error code is sticky.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Tuple

import torch

from .enums import EMPTY_EVENT_ID, EMPTY_VERSION, FIRST_EVENT_ID, WorkflowState
from .layout import DEFAULT_LAYOUT, PAD, PayloadLayout

I64 = torch.int64
I32 = torch.int32
BOOL = torch.bool


@dataclass
class ActivityTable:
    """Pending activities (persistence ActivityInfo)."""

    occ: torch.Tensor             # [W, K] bool
    schedule_id: torch.Tensor     # [W, K] i64
    started_id: torch.Tensor      # [W, K] i64
    version: torch.Tensor         # [W, K] i64
    activity_key: torch.Tensor    # [W, K] i64 (interned ActivityID)
    scheduled_time: torch.Tensor  # [W, K] i64 nanos
    started_time: torch.Tensor    # [W, K] i64 nanos
    last_heartbeat: torch.Tensor  # [W, K] i64 nanos
    sched_to_start: torch.Tensor  # [W, K] i64 seconds
    sched_to_close: torch.Tensor  # [W, K] i64 seconds
    start_to_close: torch.Tensor  # [W, K] i64 seconds
    heartbeat: torch.Tensor       # [W, K] i64 seconds
    cancel_requested: torch.Tensor   # [W, K] bool
    cancel_request_id: torch.Tensor  # [W, K] i64
    attempt: torch.Tensor         # [W, K] i64
    timer_status: torch.Tensor    # [W, K] i32
    has_retry: torch.Tensor       # [W, K] bool
    batch_id: torch.Tensor        # [W, K] i64


@dataclass
class TimerTable:
    """Pending user timers (TimerInfo)."""

    occ: torch.Tensor          # [W, K] bool
    timer_key: torch.Tensor    # [W, K] i64 (interned TimerID)
    started_id: torch.Tensor   # [W, K] i64
    expiry_time: torch.Tensor  # [W, K] i64 nanos
    task_status: torch.Tensor  # [W, K] i32
    version: torch.Tensor      # [W, K] i64


@dataclass
class ChildTable:
    """Pending child workflows (ChildExecutionInfo)."""

    occ: torch.Tensor           # [W, K] bool
    initiated_id: torch.Tensor  # [W, K] i64
    started_id: torch.Tensor    # [W, K] i64
    version: torch.Tensor       # [W, K] i64
    batch_id: torch.Tensor      # [W, K] i64


@dataclass
class InitiatedTable:
    """Pending external request-cancels / signals."""

    occ: torch.Tensor           # [W, K] bool
    initiated_id: torch.Tensor  # [W, K] i64
    version: torch.Tensor       # [W, K] i64
    batch_id: torch.Tensor      # [W, K] i64


@dataclass
class ReplayState:
    """All per-workflow state carried through the event scan."""

    state: torch.Tensor                 # [W] i32 WorkflowState
    close_status: torch.Tensor          # [W] i32 CloseStatus
    cancel_requested: torch.Tensor      # [W] bool
    last_first_event_id: torch.Tensor   # [W] i64
    next_event_id: torch.Tensor         # [W] i64
    last_processed_event: torch.Tensor  # [W] i64
    signal_count: torch.Tensor          # [W] i64
    decision_version: torch.Tensor      # [W] i64
    decision_schedule_id: torch.Tensor  # [W] i64
    decision_started_id: torch.Tensor   # [W] i64
    decision_attempt: torch.Tensor      # [W] i64
    decision_timeout: torch.Tensor      # [W] i64 seconds
    decision_scheduled_ts: torch.Tensor  # [W] i64 nanos
    decision_started_ts: torch.Tensor   # [W] i64 nanos
    decision_original_scheduled_ts: torch.Tensor  # [W] i64 nanos
    workflow_timeout: torch.Tensor      # [W] i64 seconds
    decision_sts_timeout: torch.Tensor  # [W] i64 seconds
    start_timestamp: torch.Tensor       # [W] i64 nanos
    completion_event_batch_id: torch.Tensor  # [W] i64
    last_event_task_id: torch.Tensor    # [W] i64
    workflow_attempt: torch.Tensor      # [W] i64
    expiration_time: torch.Tensor       # [W] i64 nanos
    has_parent: torch.Tensor            # [W] bool
    current_version: torch.Tensor       # [W] i64
    vh_event_ids: torch.Tensor          # [W, B, Kv] i64 (PAD-filled)
    vh_versions: torch.Tensor           # [W, B, Kv] i64 (PAD-filled)
    vh_count: torch.Tensor              # [W, B] i32
    current_branch: torch.Tensor        # [W] i32
    activities: ActivityTable
    timers: TimerTable
    children: ChildTable
    cancels: InitiatedTable
    signals: InitiatedTable
    error: torch.Tensor                 # [W] i32 (0 = healthy, else ErrorCode)


class ErrorCode:
    """First-failure codes recorded in ReplayState.error."""

    NONE = 0
    INVALID_STATE_TRANSITION = 1
    VERSION_HISTORY_ORDER = 2
    VERSION_HISTORY_OVERFLOW = 3
    MISSING_DECISION = 4
    MISSING_ACTIVITY = 5
    MISSING_TIMER = 6
    MISSING_CHILD = 7
    MISSING_REQUEST_CANCEL = 8
    MISSING_SIGNAL = 9
    TABLE_OVERFLOW = 10
    UNKNOWN_EVENT_TYPE = 11
    INVALID_BACKOFF_INITIATOR = 12
    BRANCH_OVERFLOW = 13
    BAD_FORK = 14


#: error codes a widened-K re-replay can clear: the history is valid, the
#: fixed capacities just weren't enough. Every other code is a genuine
#: history error no capacity would fix.
CAPACITY_ERRORS = (
    ErrorCode.VERSION_HISTORY_OVERFLOW,
    ErrorCode.TABLE_OVERFLOW,
    ErrorCode.BRANCH_OVERFLOW,
)

_TABLES = ("activities", "timers", "children", "cancels", "signals")


def leaves(s: ReplayState) -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted name, tensor) for every state tensor, in field order."""
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if f.name in _TABLES:
            for g in dataclasses.fields(v):
                yield f"{f.name}.{g.name}", getattr(v, g.name)
        else:
            yield f.name, v


def map_state(fn, *states: ReplayState) -> ReplayState:
    """Apply fn leaf-wise over one or more states of the same structure."""
    first = states[0]
    kw = {}
    for f in dataclasses.fields(first):
        if f.name in _TABLES:
            tables = [getattr(s, f.name) for s in states]
            kw[f.name] = type(tables[0])(**{
                g.name: fn(*(getattr(t, g.name) for t in tables))
                for g in dataclasses.fields(tables[0])})
        else:
            kw[f.name] = fn(*(getattr(s, f.name) for s in states))
    return ReplayState(**kw)


def init_state(num_workflows: int, layout: PayloadLayout = DEFAULT_LAYOUT,
               device=None) -> ReplayState:
    """Fresh state for W workflows, matching the oracle's ExecutionInfo
    defaults, on `device`."""
    W = num_workflows

    def full(shape, value, dtype=I64):
        return torch.full(shape, value, dtype=dtype, device=device)

    def zeros(shape, dtype=I64):
        return torch.zeros(shape, dtype=dtype, device=device)

    Ka, Kt = layout.max_activities, layout.max_timers
    Kc, Kr, Ks = layout.max_children, layout.max_request_cancels, layout.max_signals
    Kv = layout.max_version_history_items
    B = layout.max_branches

    def initiated(K):
        return InitiatedTable(occ=zeros((W, K), BOOL), initiated_id=zeros((W, K)),
                              version=zeros((W, K)), batch_id=zeros((W, K)))

    return ReplayState(
        state=full((W,), int(WorkflowState.Created), I32),
        close_status=zeros((W,), I32),
        cancel_requested=zeros((W,), BOOL),
        last_first_event_id=full((W,), FIRST_EVENT_ID),
        next_event_id=full((W,), FIRST_EVENT_ID),
        last_processed_event=full((W,), EMPTY_EVENT_ID),
        signal_count=zeros((W,)),
        decision_version=full((W,), EMPTY_VERSION),
        decision_schedule_id=full((W,), EMPTY_EVENT_ID),
        decision_started_id=full((W,), EMPTY_EVENT_ID),
        decision_attempt=zeros((W,)),
        decision_timeout=zeros((W,)),
        decision_scheduled_ts=zeros((W,)),
        decision_started_ts=zeros((W,)),
        decision_original_scheduled_ts=zeros((W,)),
        workflow_timeout=zeros((W,)),
        decision_sts_timeout=zeros((W,)),
        start_timestamp=zeros((W,)),
        completion_event_batch_id=full((W,), EMPTY_EVENT_ID),
        last_event_task_id=zeros((W,)),
        workflow_attempt=zeros((W,)),
        expiration_time=zeros((W,)),
        has_parent=zeros((W,), BOOL),
        current_version=full((W,), EMPTY_VERSION),
        vh_event_ids=full((W, B, Kv), int(PAD)),
        vh_versions=full((W, B, Kv), int(PAD)),
        vh_count=zeros((W, B), I32),
        current_branch=zeros((W,), I32),
        activities=ActivityTable(
            occ=zeros((W, Ka), BOOL),
            schedule_id=zeros((W, Ka)), started_id=zeros((W, Ka)),
            version=zeros((W, Ka)), activity_key=zeros((W, Ka)),
            scheduled_time=zeros((W, Ka)), started_time=zeros((W, Ka)),
            last_heartbeat=zeros((W, Ka)),
            sched_to_start=zeros((W, Ka)), sched_to_close=zeros((W, Ka)),
            start_to_close=zeros((W, Ka)), heartbeat=zeros((W, Ka)),
            cancel_requested=zeros((W, Ka), BOOL), cancel_request_id=zeros((W, Ka)),
            attempt=zeros((W, Ka)), timer_status=zeros((W, Ka), I32),
            has_retry=zeros((W, Ka), BOOL), batch_id=zeros((W, Ka)),
        ),
        timers=TimerTable(
            occ=zeros((W, Kt), BOOL), timer_key=zeros((W, Kt)),
            started_id=zeros((W, Kt)), expiry_time=zeros((W, Kt)),
            task_status=zeros((W, Kt), I32), version=zeros((W, Kt)),
        ),
        children=ChildTable(
            occ=zeros((W, Kc), BOOL), initiated_id=zeros((W, Kc)),
            started_id=zeros((W, Kc)), version=zeros((W, Kc)),
            batch_id=zeros((W, Kc)),
        ),
        cancels=initiated(Kr),
        signals=initiated(Ks),
        error=zeros((W,), I32),
    )


def layout_of(s: ReplayState) -> PayloadLayout:
    """Recover the PayloadLayout a state was built with (from its shapes)."""
    return PayloadLayout(
        max_version_history_items=s.vh_event_ids.shape[2],
        max_activities=s.activities.occ.shape[1],
        max_timers=s.timers.occ.shape[1],
        max_children=s.children.occ.shape[1],
        max_request_cancels=s.cancels.occ.shape[1],
        max_signals=s.signals.occ.shape[1],
        max_branches=s.vh_event_ids.shape[1],
    )


def reset_rows(s: ReplayState, mask: torch.Tensor) -> ReplayState:
    """Blend fresh init values into the rows where `mask` holds — the
    continue-as-new run boundary. The sticky error code survives."""
    fresh = init_state(s.state.shape[0], layout_of(s), s.state.device)

    def blend(cur, new):
        m = mask.reshape((-1,) + (1,) * (cur.dim() - 1))
        return torch.where(m, new, cur)

    out = map_state(blend, s, fresh)
    out.error = s.error
    return out
