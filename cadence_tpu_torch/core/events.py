"""History event model.

The reference represents each history event as a large union struct with one
pointer-to-attributes field per event type
(common/types/shared.go `HistoryEvent`). Here an event is a
small record: (id, type, version, timestamp, task_id) plus a flat attribute
mapping. Only attributes that drive mutable-state transitions are modeled —
payload blobs (inputs/results/details) never affect replay state in the
reference (verified against state_builder.go:132-646 attribute usage), so they
stay host-side and out of the device path by design.

String-valued attributes (activity IDs, timer IDs, task lists, run IDs) are
interned to dense integer keys by the batch encoder (`ops/encode.py`); the
oracle operates on the raw strings.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .enums import EventType


@dataclass(slots=True)
class HistoryEvent:
    """One workflow history event.

    Mirrors the fields of the reference `types.HistoryEvent` that replay
    consumes: ID, type, version, timestamp (unix nanos), task ID, and the
    per-type attributes (flattened into `attrs`).
    """

    id: int
    event_type: EventType
    version: int = 0
    timestamp: int = 0  # unix nanos
    task_id: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)

    def get(self, name: str, default: Any = None) -> Any:
        return self.attrs.get(name, default)

    def __repr__(self) -> str:  # compact, for test failure messages
        return (
            f"Event(id={self.id}, {self.event_type.name}, v={self.version}, "
            f"ts={self.timestamp}, {self.attrs})"
        )


@dataclass(slots=True)
class RetryPolicy:
    """Mirrors types.RetryPolicy fields used by replay.

    Reference: mutable_state_builder.go:1803-1811 (workflow) and
    :2181-2190 (activity).
    """

    initial_interval_seconds: int = 0
    backoff_coefficient: float = 0.0
    maximum_interval_seconds: int = 0
    maximum_attempts: int = 0
    expiration_interval_seconds: int = 0
    non_retriable_error_reasons: List[str] = field(default_factory=list)


@dataclass(slots=True)
class WorkflowExecution:
    workflow_id: str
    run_id: str


@dataclass(slots=True)
class HistoryBatch:
    """A contiguous batch of events for one run, as fed to ApplyEvents.

    Reference: `ApplyEvents(domainID, requestID, execution, history,
    newRunHistory)` at state_builder.go:90-96. `first_event_id`/`next_event_id`
    are derived from the events.
    """

    domain_id: str
    workflow_id: str
    run_id: str
    events: List[HistoryEvent]
    request_id: str = "replay-request"
    new_run_events: Optional[List[HistoryEvent]] = None

    @property
    def first_event_id(self) -> int:
        return self.events[0].id

    @property
    def last_event_id(self) -> int:
        return self.events[-1].id
