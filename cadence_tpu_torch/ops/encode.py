"""Host-side event packing: histories → dense [W, E, L] int64 lane tensors.

The reference decodes thriftrw/JSON event blobs into Go structs per event
(common/persistence/serialization/serializer.go); here batches are packed
into a fixed lane schema the device kernel can scan. String identifiers
(activity IDs, timer IDs) are interned to dense per-workflow integer keys —
state transitions only ever compare them for equality
(state_builder.go:132-646 uses no payload bytes), so payloads stay host-side.

This pure-Python packer is the reference implementation; the C++ packer in
native/ implements the same schema for production feed rates.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.enums import EventType
from ..core.events import HistoryBatch

# Lane indices
LANE_EVENT_ID = 0    # 0 = padding row
LANE_EVENT_TYPE = 1  # EventType value; -1 on padding
LANE_VERSION = 2
LANE_TIMESTAMP = 3
LANE_TASK_ID = 4
LANE_BATCH_FIRST = 5  # first event ID of the enclosing batch
LANE_BATCH_LAST = 6   # 1 if this is the last event of its batch
LANE_A0 = 7
NUM_ATTR_LANES = 8
# tree/chain lanes (after the attribute block so attr indices stay stable)
LANE_BRANCH = LANE_A0 + NUM_ATTR_LANES      # version-history branch index
LANE_PARENT = LANE_BRANCH + 1               # branch to fork-inherit items from
LANE_FLAGS = LANE_PARENT + 1                # FLAG_* bitmask
NUM_LANES = LANE_FLAGS + 1  # 18

# LANE_FLAGS bits
FLAG_RUN_RESET = 1  # first event of a continued-as-new run: reset row state
FLAG_VH_ONLY = 2    # event updates its branch's version history only (the
                    # non-current-branch persist path of NDC conflict
                    # resolution, ndc/branch_manager.go); no state transition


class _Interner:
    """Per-workflow string → dense int key (starting at 1; 0 = absent)."""

    def __init__(self) -> None:
        self._map: Dict[str, int] = {}

    def key(self, s: str) -> int:
        if s not in self._map:
            self._map[s] = len(self._map) + 1
        return self._map[s]


def _encode_attrs(ev, interner: _Interner) -> List[int]:
    """Per-type attribute lanes a0..a7. Must stay in lockstep with
    transitions.py's lane reads."""
    a = [0] * NUM_ATTR_LANES
    et = ev.event_type
    g = ev.get

    if et == EventType.WorkflowExecutionStarted:
        a[0] = g("execution_start_to_close_timeout_seconds", 0) or 0
        a[1] = g("task_start_to_close_timeout_seconds", 0) or 0
        a[2] = g("first_decision_task_backoff_seconds", 0) or 0
        a[3] = g("attempt", 0) or 0
        a[4] = g("expiration_timestamp", 0) or 0
        a[5] = 1 if g("parent_workflow_id") else 0
        a[6] = 1 if g("retry_policy") is not None else 0
        initiator = g("initiator")
        a[7] = -1 if initiator is None else int(initiator)
    elif et == EventType.DecisionTaskScheduled:
        a[0] = g("start_to_close_timeout_seconds", 0) or 0
        a[1] = g("attempt", 0) or 0
    elif et == EventType.DecisionTaskStarted:
        a[0] = g("scheduled_event_id", 0)
    elif et == EventType.DecisionTaskCompleted:
        a[0] = g("scheduled_event_id", 0)
        a[1] = g("started_event_id", 0)
    elif et == EventType.DecisionTaskTimedOut:
        a[0] = int(g("timeout_type", 0))
    elif et == EventType.ActivityTaskScheduled:
        a[0] = interner.key("act:" + g("activity_id", ""))
        a[1] = g("schedule_to_start_timeout_seconds", 0) or 0
        a[2] = g("schedule_to_close_timeout_seconds", 0) or 0
        a[3] = g("start_to_close_timeout_seconds", 0) or 0
        a[4] = g("heartbeat_timeout_seconds", 0) or 0
        retry = g("retry_policy")
        a[5] = 1 if retry is not None else 0
        a[6] = retry.expiration_interval_seconds if retry is not None else 0
    elif et == EventType.ActivityTaskStarted:
        a[0] = g("scheduled_event_id", 0)
    elif et in (
        EventType.ActivityTaskCompleted,
        EventType.ActivityTaskFailed,
        EventType.ActivityTaskTimedOut,
        EventType.ActivityTaskCanceled,
    ):
        a[0] = g("scheduled_event_id", 0)
    elif et == EventType.ActivityTaskCancelRequested:
        a[0] = interner.key("act:" + g("activity_id", ""))
    elif et == EventType.TimerStarted:
        a[0] = interner.key("timer:" + g("timer_id", ""))
        a[1] = g("start_to_fire_timeout_seconds", 0) or 0
    elif et in (EventType.TimerFired, EventType.TimerCanceled):
        a[0] = interner.key("timer:" + g("timer_id", ""))
    elif et == EventType.ChildWorkflowExecutionStarted:
        a[0] = g("initiated_event_id", 0)
    elif et in (
        EventType.StartChildWorkflowExecutionFailed,
        EventType.ChildWorkflowExecutionCompleted,
        EventType.ChildWorkflowExecutionFailed,
        EventType.ChildWorkflowExecutionCanceled,
        EventType.ChildWorkflowExecutionTimedOut,
        EventType.ChildWorkflowExecutionTerminated,
    ):
        a[0] = g("initiated_event_id", 0)
    elif et in (
        EventType.RequestCancelExternalWorkflowExecutionFailed,
        EventType.ExternalWorkflowExecutionCancelRequested,
        EventType.SignalExternalWorkflowExecutionFailed,
        EventType.ExternalWorkflowExecutionSignaled,
    ):
        a[0] = g("initiated_event_id", 0)
    # remaining types carry no state-relevant attributes
    return a


def _emit_events(out: np.ndarray, row: int, events, interner: _Interner,
                 branch: int = 0, parent: int = 0, flags: int = 0,
                 reset_first: bool = False) -> int:
    """Pack one batch's events at `row`; the single lane-writing loop every
    encoder shares. Returns the next free row."""
    max_events = out.shape[0]
    first_id = events[0].id
    for j, ev in enumerate(events):
        if row >= max_events:
            raise OverflowError(f"history has more than {max_events} events")
        out[row, LANE_EVENT_ID] = ev.id
        out[row, LANE_EVENT_TYPE] = int(ev.event_type)
        out[row, LANE_VERSION] = ev.version
        out[row, LANE_TIMESTAMP] = ev.timestamp
        out[row, LANE_TASK_ID] = ev.task_id
        out[row, LANE_BATCH_FIRST] = first_id
        out[row, LANE_BATCH_LAST] = 1 if j == len(events) - 1 else 0
        out[row, LANE_A0:LANE_A0 + NUM_ATTR_LANES] = _encode_attrs(ev, interner)
        out[row, LANE_BRANCH] = branch
        out[row, LANE_PARENT] = parent
        out[row, LANE_FLAGS] = (flags | FLAG_RUN_RESET
                                if reset_first and j == 0 else flags)
        row += 1
    return row


def encode_history(batches: Sequence[HistoryBatch], max_events: int) -> np.ndarray:
    """Pack one workflow's batched history into [E, L] lanes (zero-padded).

    A batch carrying `new_run_events` (continue-as-new: cron, retry, or an
    explicit ContinueAsNew decision) chains the new run into the SAME row:
    its first event is flagged FLAG_RUN_RESET, which makes the kernel reset
    that workflow's carried state at the boundary (the device analog of the
    reference starting a fresh mutableStateBuilder for the new run,
    state_builder.go:446-520 applyEvents newRunHistory). The row's final
    state is therefore the LAST run's state."""
    out = np.zeros((max_events, NUM_LANES), dtype=np.int64)
    out[:, LANE_EVENT_TYPE] = -1
    interner = _Interner()
    row = 0
    for batch in batches:
        row = _emit_events(out, row, batch.events, interner)
        if batch.new_run_events:
            # fresh interner: the new run's string IDs are a new namespace
            interner = _Interner()
            row = _emit_events(out, row, batch.new_run_events, interner,
                               reset_first=True)
    return out


def encode_batches_resumable(batches: Sequence[HistoryBatch],
                             interner_map: "Dict[str, int]" = None
                             ) -> "Tuple[np.ndarray, Dict[str, int]]":
    """Pack batches into UNPADDED [n, L] rows, resuming from a prior
    interner state: feeding appended batches back in (with the returned
    map) extends the lanes byte-identically to encode_history having seen
    the whole history at once. This is the pack cache's suffix-pack
    primitive (engine/cache.py PackCache): histories are append-only, so
    a re-verify after one appended batch only pays for the suffix.

    Returns (rows, interner_map) — the map is a snapshot (the caller may
    cache it; later calls never mutate an earlier snapshot)."""
    total = history_length(batches)
    out = np.zeros((total, NUM_LANES), dtype=np.int64)
    out[:, LANE_EVENT_TYPE] = -1
    interner = _Interner()
    if interner_map:
        interner._map = dict(interner_map)
    row = 0
    for batch in batches:
        row = _emit_events(out, row, batch.events, interner)
        if batch.new_run_events:
            # fresh interner: the new run's string IDs are a new namespace
            interner = _Interner()
            row = _emit_events(out, row, batch.new_run_events, interner,
                               reset_first=True)
    return out[:row], dict(interner._map)


def assemble_corpus(rows_list: Sequence[np.ndarray],
                    max_events: int = 0) -> np.ndarray:
    """Stack per-workflow UNPADDED [n, L] row blocks into a padded
    [W, E, L] corpus, byte-identical to encode_corpus on the same
    histories (pad rows are zero with event_type -1)."""
    if max_events <= 0:
        max_events = max((r.shape[0] for r in rows_list), default=0)
    W = len(rows_list)
    out = np.zeros((W, max_events, NUM_LANES), dtype=np.int64)
    out[:, :, LANE_EVENT_TYPE] = -1
    for i, rows in enumerate(rows_list):
        out[i, :rows.shape[0]] = rows
    return out


def gather_subcorpus(events: np.ndarray, indices,
                     pad_workflows: int = 0,
                     pad_events: int = 0) -> np.ndarray:
    """Gather flagged rows of a packed [W, E, L] corpus into a compact
    [F', E', L] sub-corpus for widened-K re-replay (engine/ladder.py).

    The event axis is trimmed to the FLAGGED rows' longest real history
    (the whole point of the gather: a 2.7% flagged fraction re-replays a
    ~2.7%-sized corpus, not the original), then padded up to `pad_events`;
    the workflow axis pads up to `pad_workflows`. Padding rows/slots are
    no-op lanes (event_type -1, id 0 — the kernel skips them), so padded
    shapes can be pow2-bucketed for executable reuse without changing any
    real row's result."""
    idx = np.asarray(indices, dtype=np.int64)
    sub = events[idx]
    real = sub[:, :, LANE_EVENT_ID] > 0
    e_real = (int(real.any(axis=0).nonzero()[0].max()) + 1
              if real.any() else 1)
    E = max(e_real, pad_events)
    W = max(len(idx), pad_workflows)
    out = np.zeros((W, E, NUM_LANES), dtype=np.int64)
    out[:, :, LANE_EVENT_TYPE] = -1
    out[:len(idx), :e_real] = sub[:, :e_real]
    return out


def encode_chain(runs: Sequence[Sequence[HistoryBatch]],
                 max_events: int) -> np.ndarray:
    """Pack a continue-as-new chain (a list of runs, each a list of batches)
    into one [E, L] row: each later run starts with FLAG_RUN_RESET."""
    out = np.zeros((max_events, NUM_LANES), dtype=np.int64)
    out[:, LANE_EVENT_TYPE] = -1
    row = 0
    for r, run in enumerate(runs):
        part = encode_history(run, max_events - row)
        n = int((part[:, LANE_EVENT_ID] > 0).sum())
        out[row:row + n] = part[:n]
        if r > 0:
            out[row, LANE_FLAGS] = int(out[row, LANE_FLAGS]) | FLAG_RUN_RESET
        row += n
    return out


def encode_segments(segments: Sequence[tuple], max_events: int) -> np.ndarray:
    """Pack one workflow's branched history tree into [E, L] lanes.

    Each segment is (batches, branch, parent, vh_only):
    - `branch`: version-history branch index these events belong to;
    - `parent`: branch whose items the target branch fork-inherits when it
      receives its first item (versionHistory.go DuplicateUntilLCAItem on
      device); pass parent == branch for no inheritance;
    - `vh_only`: True for events persisted to a non-current branch without
      touching mutable state (ndc conflict resolution's passive persist).

    Segments are emitted in order; interning is shared across segments (all
    branches of a run share the workflow's string namespace)."""
    out = np.zeros((max_events, NUM_LANES), dtype=np.int64)
    out[:, LANE_EVENT_TYPE] = -1
    interner = _Interner()
    row = 0
    for batches, branch, parent, vh_only in segments:
        flags = FLAG_VH_ONLY if vh_only else 0
        for batch in batches:
            if batch.new_run_events:
                # segment encoding is per-run (branch trees belong to ONE
                # run); chains must go through encode_history/encode_chain
                raise ValueError(
                    "segment batch carries new_run_events; encode the "
                    "continued-as-new chain via encode_chain instead"
                )
            row = _emit_events(out, row, batch.events, interner,
                               branch=branch, parent=parent, flags=flags)
    return out


def encode_segment_corpus(workflows: Sequence[Sequence[tuple]],
                          max_events: int = 0) -> np.ndarray:
    """Pack a corpus of branched histories (each a segment list) into
    [W, E, L]."""
    if max_events <= 0:
        max_events = max(
            sum(sum(len(b.events) for b in seg[0]) for seg in segs)
            for segs in workflows
        )
    return np.stack([encode_segments(s, max_events) for s in workflows])


def history_length(batches: Sequence[HistoryBatch]) -> int:
    """Total packed rows for one history, counting chained new-run events."""
    return sum(
        len(b.events) + len(b.new_run_events or ()) for b in batches
    )


def encode_corpus(histories: Sequence[Sequence[HistoryBatch]],
                  max_events: int = 0) -> np.ndarray:
    """Pack a corpus into [W, E, L]; E = max history length (or `max_events`)."""
    if max_events <= 0:
        max_events = max(history_length(h) for h in histories)
    return np.stack([encode_history(h, max_events) for h in histories])


# ---------------------------------------------------------------------------
# Lane decoding (the packer's inverse, for oracle spot-parity on natively
# generated corpora — string identifiers are synthesized from their
# interned keys, which is payload-neutral: the canonical checksum payload
# carries only numeric ids)
# ---------------------------------------------------------------------------

_DECODE_ATTRS = {
    EventType.WorkflowExecutionStarted: (
        "execution_start_to_close_timeout_seconds",
        "task_start_to_close_timeout_seconds",
        "first_decision_task_backoff_seconds", "attempt",
        "expiration_timestamp", None, None, "initiator"),
    EventType.DecisionTaskScheduled: (
        "start_to_close_timeout_seconds", "attempt"),
    EventType.DecisionTaskStarted: ("scheduled_event_id",),
    EventType.DecisionTaskCompleted: ("scheduled_event_id",
                                      "started_event_id"),
    EventType.DecisionTaskTimedOut: ("timeout_type",),
    EventType.ActivityTaskStarted: ("scheduled_event_id",),
    EventType.ActivityTaskCompleted: ("scheduled_event_id",),
    EventType.ActivityTaskFailed: ("scheduled_event_id",),
    EventType.ActivityTaskTimedOut: ("scheduled_event_id",),
    EventType.ActivityTaskCanceled: ("scheduled_event_id",),
}
_INITIATED_REF_TYPES = frozenset({
    EventType.ChildWorkflowExecutionStarted,
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
})


def decode_lanes(rows: np.ndarray, domain_id: str = "bench-domain",
                 workflow_id: str = "wf", run_id: str = "run"
                 ) -> List[HistoryBatch]:
    """One workflow's [E, L] lanes → oracle-replayable batches."""
    from ..core.events import HistoryEvent

    batches: List[HistoryBatch] = []
    events: List = []
    for row in rows:
        if row[LANE_EVENT_ID] <= 0:
            continue
        et = EventType(int(row[LANE_EVENT_TYPE]))
        a = [int(v) for v in row[LANE_A0:LANE_A0 + NUM_ATTR_LANES]]
        attrs = {}
        if et == EventType.ActivityTaskScheduled:
            attrs = dict(activity_id=f"act-{a[0]}",
                         schedule_to_start_timeout_seconds=a[1],
                         schedule_to_close_timeout_seconds=a[2],
                         start_to_close_timeout_seconds=a[3],
                         heartbeat_timeout_seconds=a[4])
        elif et == EventType.ActivityTaskCancelRequested:
            attrs = dict(activity_id=f"act-{a[0]}")
        elif et == EventType.TimerStarted:
            attrs = dict(timer_id=f"timer-{a[0]}",
                         start_to_fire_timeout_seconds=a[1])
        elif et in (EventType.TimerFired, EventType.TimerCanceled):
            attrs = dict(timer_id=f"timer-{a[0]}")
        elif et in _INITIATED_REF_TYPES:
            attrs = dict(initiated_event_id=a[0])
        else:
            names = _DECODE_ATTRS.get(et, ())
            for i, name in enumerate(names):
                if name is not None:
                    attrs[name] = a[i]
            if et == EventType.WorkflowExecutionStarted:
                if attrs.get("initiator") == -1:
                    attrs.pop("initiator")
        events.append(HistoryEvent(
            id=int(row[LANE_EVENT_ID]), event_type=et,
            version=int(row[LANE_VERSION]),
            timestamp=int(row[LANE_TIMESTAMP]),
            task_id=int(row[LANE_TASK_ID]), attrs=attrs))
        if row[LANE_BATCH_LAST] == 1:
            batches.append(HistoryBatch(
                domain_id=domain_id, workflow_id=workflow_id,
                run_id=run_id, events=events))
            events = []
    if events:
        raise ValueError("lanes end mid-batch (no batch_last marker)")
    return batches


# ---------------------------------------------------------------------------
# wire32: the int32 transfer format
# ---------------------------------------------------------------------------
# Host→device bytes are the scarce resource over the host link; all but
# two lanes fit int32 (event IDs, versions, timeouts, interned keys —
# state_builder.go:132-646 consumes nothing wider), so the wire format
# ships 20 int32 lanes instead of 18 int64: the two 64-bit values
# (LANE_TIMESTAMP nanos, and the Started event's absolute
# expiration_timestamp in attr lane 4) travel split as lo/hi halves and
# are reconstructed exactly on device (ops/replay.py widen_wire32).

LANE32_TS_HI = NUM_LANES       # hi-32 of LANE_TIMESTAMP
LANE32_A4_HI = NUM_LANES + 1   # hi-32 of attr lane a4 (expiration nanos)
NUM_LANES32 = NUM_LANES + 2    # 20

_WIDE_LANES = (LANE_TIMESTAMP, LANE_A0 + 4)


def to_wire32(events: np.ndarray) -> np.ndarray:
    """[.., NUM_LANES] int64 → [.., NUM_LANES32] int32 (exact: wide lanes
    split lo/hi). Raises OverflowError if any lane that must fit int32
    doesn't — callers then stay on the int64 path rather than corrupt."""
    ev = np.asarray(events, dtype=np.int64)
    narrow = [i for i in range(NUM_LANES) if i not in _WIDE_LANES]
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    bad = (ev[..., narrow] < lo) | (ev[..., narrow] > hi)
    if bad.any():
        lanes = sorted({narrow[i] for i in np.argwhere(bad)[:, -1]})
        raise OverflowError(f"lanes {lanes} exceed int32; use the int64 path")
    out = np.empty(ev.shape[:-1] + (NUM_LANES32,), dtype=np.int32)
    out[..., :NUM_LANES] = ev.astype(np.int32)  # wraps → lo32 halves
    out[..., LANE32_TS_HI] = (ev[..., LANE_TIMESTAMP] >> 32).astype(np.int32)
    out[..., LANE32_A4_HI] = (ev[..., LANE_A0 + 4] >> 32).astype(np.int32)
    return out
