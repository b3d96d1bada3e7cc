"""History event notifier: pub/sub that wakes long-poll waiters.

Reference: service/history/events/notifier.go:43-48 — every committed
transaction publishes (execution, next event ID, close status); frontend
GetWorkflowExecutionHistory long-polls block on it instead of busy-reading
(workflowHandler.go:2106 → history long-poll loop).

Wakeups are PER-EXECUTION: each watched execution owns its condition
variable (the reference's per-execution subscriber channels), so a commit
wakes only that execution's parked polls — never O(all parked polls in
the process) as a single global condvar would.
Condvars are created on first wait and dropped when the last waiter
leaves, so the registry tracks WATCHED executions, not all executions.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

Key = Tuple[str, str, str]


class _Watch:
    __slots__ = ("cond", "waiters")

    def __init__(self, lock: threading.Lock) -> None:
        self.cond = threading.Condition(lock)
        self.waiters = 0


class HistoryNotifier:
    """Per-cluster notifier keyed by (domain_id, workflow_id, run_id)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: latest published (next_event_id, workflow_closed) per execution
        self._latest: Dict[Key, Tuple[int, bool]] = {}
        #: executions with parked waiters → their condition variable
        self._watches: Dict[Key, _Watch] = {}

    def notify(self, key: Key, next_event_id: int, closed: bool) -> None:
        """NotifyNewHistoryEvent (historyEngine commit hook)."""
        with self._lock:
            cur = self._latest.get(key)
            if cur is None:
                self._latest[key] = (next_event_id, closed)
            else:
                # merge: the event-id high-water mark AND the closed bit —
                # an NDC rewind to a shorter closed branch must still wake
                # close-waiters even though its next_event_id is lower
                self._latest[key] = (max(cur[0], next_event_id),
                                     cur[1] or closed)
            watch = self._watches.get(key)
            if watch is not None:
                watch.cond.notify_all()  # THIS execution's waiters only

    def wait_for(self, key: Key, min_next_event_id: int,
                 timeout: float = 10.0) -> bool:
        """Block until the execution's history reaches min_next_event_id
        or closes; True when progress happened, False on timeout."""
        deadline = threading.TIMEOUT_MAX if timeout is None else timeout

        def ready() -> bool:
            latest = self._latest.get(key)
            return latest is not None and (
                latest[0] >= min_next_event_id or latest[1])

        with self._lock:
            watch = self._watches.get(key)
            if watch is None:
                watch = self._watches[key] = _Watch(self._lock)
            watch.waiters += 1
            try:
                return watch.cond.wait_for(ready, timeout=deadline)
            finally:
                watch.waiters -= 1
                if watch.waiters == 0 and self._watches.get(key) is watch:
                    del self._watches[key]

    def watched(self) -> int:
        """Executions with parked waiters (tests/metrics)."""
        with self._lock:
            return len(self._watches)

    def forget(self, key: Key) -> None:
        """Drop a closed execution's entry (retention/scavenger hook)."""
        with self._lock:
            self._latest.pop(key, None)
