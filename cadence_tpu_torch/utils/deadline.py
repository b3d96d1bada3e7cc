"""Deadline propagation: a per-request time budget that rides the wire.

Reference: gRPC/YARPC deadlines — the caller's remaining budget (not an
absolute wall-clock time, which would require synchronized clocks) is
injected into every outbound envelope; each hop converts it back to a
local absolute deadline on receipt. A handler whose budget is already
exhausted rejects the request with a typed `DeadlineExceeded` BEFORE
doing any work (the reference's context.Deadline check at the top of
every handler), and socket timeouts for nested hops derive from what is
LEFT of the budget instead of a fixed per-hop constant.

The active deadline is a thread-local stack (like the tracer's
active-span stack in utils/tracing.py): a server handler `bind()`s the
extracted deadline for the duration of the dispatch, so every outbound
store/engine hop the handler makes inherits the shrinking budget
automatically — frontend→history→store chains share ONE budget.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional


class DeadlineExceeded(Exception):
    """The request's time budget expired (gRPC DEADLINE_EXCEEDED analog).

    Raised client-side when a call would start with no budget left, and
    server-side when an envelope arrives already expired — in both cases
    BEFORE burning work (a kernel launch, a store transaction) that the
    caller has already given up on. Picklable, so it crosses the wire as
    a typed service error."""


class Deadline:
    """An absolute local deadline (monotonic clock) with budget math."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float) -> None:
        self.expires_at = expires_at

    @classmethod
    def after(cls, budget_s: float) -> "Deadline":
        return cls(time.monotonic() + budget_s)

    def remaining(self) -> float:
        """Seconds of budget left (may be <= 0)."""
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(remaining={self.remaining():.3f}s)"


_local = threading.local()


def current() -> Optional[Deadline]:
    """The calling thread's active deadline, or None (no budget bound)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class bind:
    """Context manager: make `deadline` the thread's active deadline.
    `bind(None)` is a no-op pass-through, so handlers can bind whatever
    extract() returned without branching."""

    def __init__(self, deadline: Optional[Deadline]) -> None:
        self._deadline = deadline

    def __enter__(self) -> Optional[Deadline]:
        if self._deadline is not None:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            stack.append(self._deadline)
        return self._deadline

    def __exit__(self, *exc) -> None:
        if self._deadline is not None:
            _local.stack.pop()


# -- wire-envelope propagation ----------------------------------------------
#
# The deadline rides the SAME ("traced", carrier, request) envelope the
# tracer uses (utils/tracing.py inject/extract): the carrier is a plain
# dict, so a "deadline_s" key (remaining budget at send time) coexists
# with trace_id/span_id. tracing.extract() tolerates carriers without
# trace ids, so a deadline-only envelope still unwraps cleanly there.

_KEY = "deadline_s"


def inject(request: Any) -> Any:
    """Attach the thread's remaining budget to an outbound wire request.
    Understands both a bare request and one already wrapped by
    tracing.inject(); pass-through when no deadline is bound."""
    deadline = current()
    if deadline is None:
        return request
    remaining = deadline.remaining()
    if (isinstance(request, tuple) and len(request) == 3
            and request[0] == "traced" and isinstance(request[1], dict)):
        carrier = dict(request[1])
        carrier[_KEY] = remaining
        return ("traced", carrier, request[2])
    return ("traced", {_KEY: remaining}, request)


def peek(request: Any) -> Optional[Deadline]:
    """Read the deadline off a possibly-wrapped wire request WITHOUT
    unwrapping it (tracing.extract() owns the unwrap). Tolerant of
    malformed carriers — the wire is internal, but a bad envelope must
    not take the handler down."""
    if (isinstance(request, tuple) and len(request) == 3
            and request[0] == "traced" and isinstance(request[1], dict)):
        budget = request[1].get(_KEY)
        if isinstance(budget, (int, float)):
            return Deadline.after(float(budget))
    return None
