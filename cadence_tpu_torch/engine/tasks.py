"""Host task-scheduling primitives: worker pools, fairness, redispatch,
ack management under concurrency.

Reference: common/task/parallelTaskProcessor.go (N workers over a task
channel), weightedRoundRobinTaskScheduler.go (per-key fairness),
service/history/task/redispatcher.go (retryable failures re-enter the
queue with backoff), and the queue processors' ack managers (ack level
advances only past a CONTIGUOUS prefix of completed task ids —
queue/interface.go ProcessingQueueState).

These are the active side's scale machinery (a single-threaded pump
would be the scalability ceiling). The executors overlap
I/O-bound work (store round-trips, cross-host RPC) — exactly what the
reference's worker pools overlap.
"""
from __future__ import annotations

import heapq
import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional


class AckManager:
    """Contiguous-prefix ack tracking for one queue.

    Tasks complete OUT OF ORDER under a worker pool, but the persisted ack
    level may only advance past ids with no incomplete predecessor —
    otherwise a crash loses the stragglers (the reference's processing-
    queue ack level contract)."""

    def __init__(self, initial_level: int = 0) -> None:
        self._lock = threading.Lock()
        self._level = initial_level
        #: ids registered and not yet acked past (outstanding ∪ completed-
        #: but-blocked-by-a-straggler) — the re-read dedup set
        self._seen: set = set()
        self._outstanding: set = set()
        self._heap: List[int] = []

    def register(self, task_id: int) -> bool:
        """True if newly tracked; False for ids already in flight or acked
        (the queue re-reads from the ack level every sweep, so in-flight
        tasks reappear and must not double-execute)."""
        with self._lock:
            if task_id <= self._level or task_id in self._seen:
                return False
            self._seen.add(task_id)
            self._outstanding.add(task_id)
            heapq.heappush(self._heap, task_id)
            return True

    def complete(self, task_id: int) -> None:
        with self._lock:
            self._outstanding.discard(task_id)

    def in_flight(self) -> int:
        """Registered-but-incomplete count (the merge-safety probe)."""
        with self._lock:
            return len(self._outstanding)

    def ack_level(self) -> int:
        """Highest id such that every registered id at or below it has
        completed; ids between registered ones are assumed absent (task
        ids are sparse — shard range blocks)."""
        with self._lock:
            while self._heap and self._heap[0] not in self._outstanding:
                acked = heapq.heappop(self._heap)
                self._seen.discard(acked)
                self._level = max(self._level, acked)
            return self._level


class RetryableTaskError(Exception):
    """Executor failure that should redispatch (transient store/RPC)."""


class EnvironmentalTaskError(RetryableTaskError):
    """Failure caused by the ENVIRONMENT, not the task — a dead peer, a
    partitioned store. Retries with backoff WITHOUT consuming the task's
    bounded attempts: the condition resolves when the membership ring
    re-routes (TTL), and a dispatch task dead-lettered inside that window
    is a lost decision/activity that nothing ever recovers. Matches the
    reference's redispatcher, which requeues such tasks for as long as
    the shard is owned. A high separate cap (ENV_MAX_ATTEMPTS) still
    backstops a permanently-wedged environment."""


#: environmental retries outlast any ring TTL by a wide margin (~100s at
#: the 1s backoff cap) while still bounding a truly wedged environment
ENV_MAX_ATTEMPTS = 100


class TaskScheduler:
    """Worker pool with per-key round-robin fairness + redispatch.

    parallelTaskProcessor + weightedRoundRobinTaskScheduler reduced to
    their contract: N workers drain per-key (per-domain) FIFOs in
    round-robin so one hot domain cannot starve the rest; a task raising
    RetryableTaskError re-enters its queue up to `max_attempts` times
    (redispatcher.go), then lands in the dead list — counted, never
    silently dropped."""

    def __init__(self, num_workers: int = 4, max_attempts: int = 5,
                 retry_delay: float = 0.05, metrics=None) -> None:
        from ..utils.metrics import DEFAULT_REGISTRY
        self.metrics = metrics if metrics is not None else DEFAULT_REGISTRY
        self.num_workers = num_workers
        self.max_attempts = max_attempts
        #: base of the exponential redispatch backoff (redispatcher.go):
        #: without a delay, a millisecond store blip would burn every
        #: attempt back-to-back and fast-path a recoverable task to dead
        self.retry_delay = retry_delay
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: Dict[str, Deque] = {}
        self._rr: Deque[str] = deque()
        #: redispatch parking lot: (ready_at, seq, key, fn, on_done,
        #: attempt) min-heap. Backoff is a NOT-BEFORE timestamp, not a
        #: worker-thread sleep — a retrying domain must not occupy 1/N of
        #: pool capacity while it waits (redispatcher.go's timer-driven
        #: redispatch)
        self._delayed: list = []
        self._delay_seq = 0
        self._stopping = False
        self._active = 0
        self._idle = threading.Condition(self._lock)
        self.dead: List[tuple] = []
        # named per the hostprof subsystem table (utils/hostprof.py):
        # unnamed pool threads land in "other" and count against the
        # profiler's attributed share
        self._threads = [threading.Thread(target=self._worker, daemon=True,
                                          name=f"cadence-task-worker-{i}")
                         for i in range(num_workers)]
        for t in self._threads:
            t.start()

    def submit(self, key: str, fn: Callable[[], None],
               on_done: Optional[Callable[[], None]] = None,
               _attempt: int = 0) -> None:
        with self._lock:
            if self._stopping:
                raise RuntimeError("scheduler stopped")
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
                self._rr.append(key)
            q.append((fn, on_done, _attempt))
            self._work.notify()

    def _next_locked(self):
        """Round-robin over keys with work (the fairness contract). Keys
        whose queues drained are pruned so the scan stays proportional to
        keys with PENDING work, not every key ever seen."""
        self._promote_ready_locked()
        for _ in range(len(self._rr)):
            key = self._rr[0]
            q = self._queues.get(key)
            if not q:
                self._rr.popleft()
                self._queues.pop(key, None)
                continue
            self._rr.rotate(-1)
            return key, q.popleft()
        return None

    def _worker(self) -> None:
        while True:
            with self._lock:
                item = self._next_locked()
                while item is None and not self._stopping:
                    self._work.wait(0.1)
                    item = self._next_locked()
                if item is None:
                    return
                self._active += 1
            key, (fn, on_done, attempt) = item
            try:
                fn()
            except EnvironmentalTaskError:
                if attempt + 1 >= ENV_MAX_ATTEMPTS:
                    self._kill(key, fn, "environmental retries exhausted")
                else:
                    import time as _time
                    ready_at = _time.monotonic() + min(
                        self.retry_delay * (2 ** min(attempt, 10)), 1.0)
                    with self._lock:
                        if not self._stopping:
                            import heapq
                            self._delay_seq += 1
                            heapq.heappush(self._delayed,
                                           (ready_at, self._delay_seq, key,
                                            fn, on_done, attempt + 1))
                            self._work.notify()
                    on_done = None
            except RetryableTaskError:
                if attempt + 1 >= self.max_attempts:
                    # attempts exhausted with real backoff in between: DLQ
                    # semantics — record loudly AND ack (reference moves
                    # poison to the DLQ and advances past it)
                    self._kill(key, fn, "retries exhausted")
                else:
                    # exponential redispatch backoff (redispatcher.go):
                    # park with a not-before timestamp — the worker moves
                    # straight on to other domains' tasks
                    import time as _time
                    ready_at = _time.monotonic() + min(
                        self.retry_delay * (2 ** attempt), 1.0)
                    with self._lock:
                        if not self._stopping:
                            import heapq
                            self._delay_seq += 1
                            heapq.heappush(self._delayed,
                                           (ready_at, self._delay_seq, key,
                                            fn, on_done, attempt + 1))
                            self._work.notify()
                    # stopped mid-redispatch: the parked task is dropped
                    # un-acked — it redelivers from the persisted level on
                    # restart. Either way completion fires on the final try
                    on_done = None
            except Exception:
                self._kill(key, fn, "non-retryable failure")
            finally:
                if on_done is not None:
                    try:
                        on_done()
                    except Exception:
                        pass
                with self._lock:
                    self._active -= 1
                    self._idle.notify_all()

    def _kill(self, key: str, fn, why: str) -> None:
        """Dead-letter a task: recorded, counted, logged at ERROR — and
        the caller's on_done still fires (DLQ-with-ack: the queue moves
        on; the dead list is the operator's replay surface)."""
        from ..utils.log import DEFAULT_LOGGER
        with self._lock:
            self.dead.append((key, fn))
        self.metrics.inc("task-scheduler", "dead-tasks")
        DEFAULT_LOGGER.error("task dead-lettered", component="scheduler",
                             key=key, reason=why)

    def _promote_ready_locked(self) -> None:
        """Move parked redispatches whose not-before has passed back onto
        their per-key queues (held under self._lock)."""
        if not self._delayed:
            return
        import heapq
        import time as _time
        now = _time.monotonic()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, key, fn, on_done, attempt = heapq.heappop(self._delayed)
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
                self._rr.append(key)
            q.append((fn, on_done, attempt))

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every queued task has finished (tests/pumps)."""
        import time
        deadline = time.monotonic() + timeout
        with self._lock:
            while (any(self._queues.values()) or self._active
                   or self._delayed):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(min(remaining, 0.1))
            return True

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            self._work.notify_all()
        for t in self._threads:
            t.join(timeout=5)
