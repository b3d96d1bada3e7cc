"""Consistent query: buffered queries answered at decision completion.

Reference: service/history/query/registry.go + query/query.go — a query
against a running workflow does not touch history; it parks in an
in-memory per-execution registry (states buffered → started → completed),
rides to the worker attached to the next decision task, and completes when
RespondDecisionTaskCompleted carries its result, which unblocks the
frontend caller. Queries are lost on shard movement (the reference's
registry is in-memory on the owning history host too) — callers retry.

The direct path (no decision pending: dispatch a query-only task through
matching and answer via RespondQueryTaskCompleted, matching's query task
channel) is implemented by the frontend/matching seam; this module is the
registry both paths share.
"""
from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class QueryState:
    BUFFERED = "buffered"
    STARTED = "started"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass
class PendingQuery:
    query_id: str
    query_type: str
    args: bytes = b""
    state: str = QueryState.BUFFERED
    result: Optional[bytes] = None
    failure: str = ""
    done: threading.Event = field(default_factory=threading.Event)


class QueryRegistry:
    """Per-cluster registry keyed by (domain_id, workflow_id, run_id).

    Memory bound: terminal (completed/failed) queries are evicted FIFO
    beyond MAX_TERMINAL_PER_KEY per execution (the reference removes a
    query once its termination state is delivered; keeping a bounded tail
    lets late get_query_result callers still read recent answers)."""

    MAX_TERMINAL_PER_KEY = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._queries: Dict[Tuple[str, str, str], Dict[str, PendingQuery]] = {}
        self._terminal: Dict[Tuple[str, str, str], List[str]] = {}

    def _mark_terminal_locked(self, key: Tuple[str, str, str],
                              query_id: str) -> None:
        order = self._terminal.setdefault(key, [])
        order.append(query_id)
        while len(order) > self.MAX_TERMINAL_PER_KEY:
            self._queries.get(key, {}).pop(order.pop(0), None)

    def buffer(self, key: Tuple[str, str, str], query_type: str,
               args: bytes = b"") -> str:
        """bufferQuery (registry.go:118): park a new query."""
        q = PendingQuery(query_id=str(uuid.uuid4()), query_type=query_type,
                         args=args)
        with self._lock:
            self._queries.setdefault(key, {})[q.query_id] = q
        return q.query_id

    def buffered_ids(self, key: Tuple[str, str, str]) -> List[str]:
        with self._lock:
            return [q.query_id for q in self._queries.get(key, {}).values()
                    if q.state == QueryState.BUFFERED]

    def drop_key(self, key: Tuple[str, str, str]) -> None:
        """Forget an execution entirely (retention/scavenger hook)."""
        with self._lock:
            self._queries.pop(key, None)
            self._terminal.pop(key, None)

    def attach(self, key: Tuple[str, str, str]
               ) -> List[Tuple[str, str, bytes]]:
        """Buffered → started; returns (id, type, args) triples to ship
        with an outgoing decision task (the getBufferedIDs +
        setTerminationState dance of the decision-attach path)."""
        out = []
        with self._lock:
            for q in self._queries.get(key, {}).values():
                if q.state == QueryState.BUFFERED:
                    q.state = QueryState.STARTED
                    out.append((q.query_id, q.query_type, q.args))
        return out

    def complete(self, key: Tuple[str, str, str], query_id: str,
                 result: bytes) -> bool:
        with self._lock:
            q = self._queries.get(key, {}).get(query_id)
            if q is None or q.state in (QueryState.COMPLETED, QueryState.FAILED):
                return False
            q.state = QueryState.COMPLETED
            q.result = result
            self._mark_terminal_locked(key, query_id)
        q.done.set()
        return True

    def fail_all(self, key: Tuple[str, str, str], reason: str) -> None:
        """Workflow closed / shard moved: unblock every waiter with an
        error (registry terminationState unblocked-with-error). State
        transitions stay under the lock so a racing complete() can't be
        overwritten after it already delivered a result."""
        to_signal = []
        with self._lock:
            for q in list(self._queries.get(key, {}).values()):
                if q.state not in (QueryState.COMPLETED, QueryState.FAILED):
                    q.state = QueryState.FAILED
                    q.failure = reason
                    self._mark_terminal_locked(key, q.query_id)
                    to_signal.append(q)
        for q in to_signal:
            q.done.set()

    def requeue_started(self, key: Tuple[str, str, str]) -> None:
        """A decision completed WITHOUT answering attached queries (old
        client): started queries go back to buffered for the next decision
        (historyEngine.go RespondDecisionTaskCompleted query-result
        reconciliation)."""
        with self._lock:
            for q in self._queries.get(key, {}).values():
                if q.state == QueryState.STARTED:
                    q.state = QueryState.BUFFERED

    def get(self, key: Tuple[str, str, str],
            query_id: str) -> Optional[PendingQuery]:
        with self._lock:
            return self._queries.get(key, {}).get(query_id)

    def wait(self, key: Tuple[str, str, str], query_id: str,
             timeout: float = 10.0) -> PendingQuery:
        q = self.get(key, query_id)
        if q is None:
            raise KeyError(f"unknown query {query_id}")
        q.done.wait(timeout)
        return q
