"""Matching engine: task-list dispatch between the history service and
polling workers.

Reference: service/matching/matchingEngine.go (AddDecisionTask:259,
AddActivityTask:307, PollForDecisionTask:355, PollForActivityTask:459,
getAllPartitions:729) and taskListManager.go (lease renewal :458, task ID
blocks :485, sync-match fast path :530) + forwarder.go:111 (partition →
root forwarding).

Fidelity to the reference:
- **partitions**: a task list scales out as N partitions (root = the base
  name, children = /__cadence_sys/<name>/<n>); adds and polls spread
  round-robin (the reference hashes by caller identity — same goal:
  de-hotspot the root);
- **sync-match**: a PARKED poll rendezvouses with an incoming task
  directly — no write-through, no backlog (trySyncMatch skips the
  persistence round-trip entirely);
- **forwarder**: a task added on a non-root partition whose local
  partition has no parked poller forwards to the ROOT for sync-match
  before persisting locally (ForwardTask); a poll that finds its
  partition empty forwards to the root's backlog (ForwardPoll).

Polls are non-blocking (the onebox pump loop drives them); long-poll
transports park a ParkedPoll and get the sync-match callback instead.
"""
from __future__ import annotations

import heapq
import threading
import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

from ..utils import metrics as m
from ..utils import tracing
from .persistence import PersistedTask, Stores, TaskListInfo

TASK_LIST_TYPE_DECISION = 0
TASK_LIST_TYPE_ACTIVITY = 1

PARTITION_PREFIX = "/__cadence_sys/"


@dataclass
class MatchedTask:
    domain_id: str
    workflow_id: str
    run_id: str
    schedule_id: int
    task_list: str
    #: set on query-only tasks (the consistent-query direct path: a query
    #: task rides the decision task list without any history mutation,
    #: matchingEngine QueryWorkflow passthrough)
    query_id: str = ""
    #: persisted-task identity for the two-phase ack: the store row is
    #: deleted only after the engine write behind the delivery succeeds
    #: (complete_task); 0/"" = sync-matched, nothing persisted to ack
    task_id: int = 0
    source: str = ""


class ParkedPoll:
    """A parked long-poll awaiting sync-match (the poller side of
    taskListManager.go:530 trySyncMatch). One-shot: a matched task lands
    in .task; cancel() withdraws an unmatched park."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.task: Optional[MatchedTask] = None
        self.done = threading.Event()
        self._canceled = False
        #: set by the parking manager; removes this entry from its deque
        self._unpark = None

    def _try_deliver(self, task: MatchedTask) -> bool:
        with self._lock:
            if self._canceled or self.task is not None:
                return False
            self.task = task
        self.done.set()
        return True

    def cancel(self) -> bool:
        """Withdraw (poll timeout); False if a task already matched. The
        entry leaves the manager's parked deque immediately — an idle task
        list must not accumulate dead parks."""
        with self._lock:
            if self.task is not None:
                return False
            self._canceled = True
        if self._unpark is not None:
            self._unpark()
        return True


def partition_name(base: str, partition: int) -> str:
    """getAllPartitions naming (matchingEngine.go:729)."""
    return base if partition == 0 else f"{PARTITION_PREFIX}{base}/{partition}"


class _TaskListManager:
    """One PARTITION's buffering + lease (taskListManager.go analog)."""

    def __init__(self, stores: Stores, domain_id: str, name: str,
                 task_type: int) -> None:
        self._stores = stores
        self._info: TaskListInfo = stores.task.lease_task_list(
            domain_id, name, task_type)
        self._lock = threading.Lock()
        self._buffer: Deque[PersistedTask] = deque()
        # taskReader (service/matching/taskReader.go): a fresh lessee pumps
        # the store's surviving rows back into its dispatch buffer — this
        # is what makes the two-phase ack real: a task popped but never
        # acked before the previous owner died redelivers from here
        self._buffer.extend(stores.task.get_tasks(
            domain_id, name, task_type, min_task_id=0, batch_size=10**9))
        #: query-only tasks: transient, never persisted (a lost query is
        #: retried by the caller; the reference's query tasks are sync-only)
        self._query_buffer: Deque[tuple] = deque()
        self._parked: Deque[ParkedPoll] = deque()
        self._next_task_id = self._info.range_id * 100000
        self._ack = 0
        #: popped-but-unacked persisted tasks (two-phase ack: the store row
        #: outlives delivery until the engine write succeeds, so a crash
        #: between pop and handoff cannot lose the task — the reference
        #: taskGC only deletes below the ack level, taskListManager.go)
        self._inflight: Dict[int, PersistedTask] = {}
        self._max_popped = 0
        #: ids with LIVE obligations (buffered or in flight); the lazy min-
        #: heap gives an O(log n) GC floor per ack — requeues can invert
        #: buffer order, so no positional shortcut is safe
        self._outstanding: set = set()
        self._id_heap: List[int] = []
        for t in self._buffer:
            self._track_locked(t.task_id)

    def _track_locked(self, task_id: int) -> None:
        if task_id and task_id not in self._outstanding:
            self._outstanding.add(task_id)
            heapq.heappush(self._id_heap, task_id)

    def _sync_match_locked(self, matched: MatchedTask) -> bool:
        while self._parked:
            poll = self._parked.popleft()
            if poll._try_deliver(matched):
                return True
            # canceled park: discard and retry the next one
        return False

    def try_sync_match(self, matched: MatchedTask) -> bool:
        """Hand the task to a parked poller, skipping persistence
        (taskListManager.go:530 trySyncMatch)."""
        with self._lock:
            return self._sync_match_locked(matched)

    def park_or_take(self, poll: ParkedPoll, base: str,
                     fallback: Optional["_TaskListManager"] = None) -> None:
        """ATOMIC drain-or-park: under the lock, deliver a backlog task
        (own, then the root's via `fallback` — ForwardPoll) into the poll,
        or register the park. Atomicity closes the gap where a task lands
        between a missed poll and the park and sleeps the full long-poll
        timeout. Lock order is always child → root, never the reverse."""
        with self._lock:
            if self._query_buffer:
                # a buffered query is deliverable work too (queries have no
                # redispatch timer, so a park must not sleep past one)
                q = self._query_buffer.popleft()
                poll._try_deliver(MatchedTask(
                    domain_id=q[0], workflow_id=q[1], run_id=q[2],
                    schedule_id=-1, task_list=base, query_id=q[3]))
                return
            task = self._pop_locked()
            src = self._info.name
            if task is None and fallback is not None:
                task = fallback.poll()
                src = fallback._info.name
            if task is not None:
                poll._try_deliver(MatchedTask(
                    domain_id=task.domain_id, workflow_id=task.workflow_id,
                    run_id=task.run_id, schedule_id=task.schedule_id,
                    task_list=base, task_id=task.task_id, source=src))
                return
            self._parked.append(poll)
            poll._unpark = lambda: self._remove_parked(poll)

    def _remove_parked(self, poll: ParkedPoll) -> None:
        with self._lock:
            try:
                self._parked.remove(poll)
            except ValueError:
                pass

    def add(self, domain_id: str, workflow_id: str, run_id: str,
            schedule_id: int, base: Optional[str] = None,
            forward_to: Optional["_TaskListManager"] = None) -> None:
        """Sync-match-or-persist ATOMICALLY under the lock: a parked local
        poller gets the task directly (no write-through); otherwise the
        root (`forward_to`, ForwardTask) may sync-match it; otherwise it
        persists to the local backlog. Lock order child → root only."""
        matched = MatchedTask(domain_id=domain_id, workflow_id=workflow_id,
                              run_id=run_id, schedule_id=schedule_id,
                              task_list=base or self._info.name)
        with self._lock:
            if self._sync_match_locked(matched):
                return
            if forward_to is not None and forward_to.try_sync_match(matched):
                return
            self._next_task_id += 1
            task = PersistedTask(task_id=self._next_task_id, domain_id=domain_id,
                                 workflow_id=workflow_id, run_id=run_id,
                                 schedule_id=schedule_id)
            # write-through (taskWriter batches CreateTasks) then buffer for
            # dispatch (taskReader pump)
            self._stores.task.create_tasks(self._info, [task])
            self._buffer.append(task)
            self._track_locked(task.task_id)

    def _pop_locked(self) -> Optional[PersistedTask]:
        if not self._buffer:
            return None
        task = self._buffer.popleft()
        if task.task_id:
            # two-phase: the persisted row stays until complete() — a crash
            # between pop and engine write redelivers from the store
            self._inflight[task.task_id] = task
            self._max_popped = max(self._max_popped, task.task_id)
        return task

    def complete(self, task_id: int) -> None:
        """Ack a delivered task: delete persisted rows below the lowest
        still-outstanding id (taskGC semantics — GC is best-effort and
        batched; a failed delete retries on the next ack)."""
        if not task_id:
            return
        with self._lock:
            self._inflight.pop(task_id, None)
            self._outstanding.discard(task_id)
            # lazy min-heap: entries acked since their push are skimmed off
            # the top; amortized O(log n) per ack even with requeue-order
            # inversions in the buffer
            while self._id_heap and self._id_heap[0] not in self._outstanding:
                heapq.heappop(self._id_heap)
            # the store deletes ids <= level, so the GC level sits just
            # below the lowest still-outstanding id
            level = (self._id_heap[0] - 1 if self._id_heap
                     else self._max_popped)
            if level > self._ack:
                self._ack = level
                try:
                    self._stores.task.complete_tasks_less_than(
                        self._info.domain_id, self._info.name,
                        self._info.task_type, self._ack)
                except Exception as exc:
                    # best-effort GC: deferral is fine (the next ack
                    # retries from the advanced level) but NEVER silent —
                    # a programming error or corrupted store must surface
                    from ..utils.log import DEFAULT_LOGGER
                    m.DEFAULT_REGISTRY.inc("matching", "task-gc-failures")
                    DEFAULT_LOGGER.warning(
                        "task GC deferred", component="matching",
                        task_list=self._info.name, level=self._ack,
                        error=repr(exc))

    def poll(self) -> Optional[PersistedTask]:
        with self._lock:
            return self._pop_locked()

    def requeue_front(self, task: PersistedTask) -> None:
        """Return a polled-but-undeliverable task to the head of the
        backlog (the sibling-sweep race loser / failed engine write);
        leaves the in-flight ledger — the task is queued again, not done.
        The persisted row was never deleted (two-phase ack), so the
        requeue is store-visible: a new lessee would also re-read it."""
        with self._lock:
            if task.task_id:
                self._inflight.pop(task.task_id, None)
                self._track_locked(task.task_id)
            self._buffer.appendleft(task)

    def add_query(self, domain_id: str, workflow_id: str, run_id: str,
                  query_id: str) -> None:
        """Queries sync-match a parked decision poller like any other
        decision task; otherwise they buffer (never persisted)."""
        matched = MatchedTask(domain_id=domain_id, workflow_id=workflow_id,
                              run_id=run_id, schedule_id=-1,
                              task_list=self._info.name, query_id=query_id)
        with self._lock:
            if self._sync_match_locked(matched):
                return
            self._query_buffer.append((domain_id, workflow_id, run_id,
                                       query_id))

    def poll_query(self) -> Optional[tuple]:
        with self._lock:
            return self._query_buffer.popleft() if self._query_buffer else None

    def backlog(self) -> int:
        with self._lock:
            return len(self._buffer) + len(self._query_buffer)


class MatchingEngine:
    def __init__(self, stores: Stores, config=None) -> None:
        from ..utils.dynamicconfig import DynamicConfig
        self._stores = stores
        self.config = config if config is not None else DynamicConfig()
        self._lock = threading.Lock()
        self._managers: Dict[Tuple[str, str, int], _TaskListManager] = {}
        #: round-robin cursors per (domain, base, type) for add and poll
        self._add_rr: Dict[Tuple[str, str, int], int] = {}
        self._poll_rr: Dict[Tuple[str, str, int], int] = {}
        #: (domain, base, type) → {identity: last_seen} (pollerHistory.go)
        self._pollers: Dict[Tuple[str, str, int], Dict[str, float]] = {}

    def _manager(self, domain_id: str, name: str, task_type: int
                 ) -> _TaskListManager:
        key = (domain_id, name, task_type)
        with self._lock:
            mgr = self._managers.get(key)
            if mgr is None:
                mgr = _TaskListManager(self._stores, domain_id, name, task_type)
                self._managers[key] = mgr
            return mgr

    def _num_partitions(self, base: str) -> int:
        from ..utils.dynamicconfig import KEY_MATCHING_NUM_PARTITIONS
        if base.startswith(PARTITION_PREFIX):
            return 1  # already a partition name
        return max(1, int(self.config.get(KEY_MATCHING_NUM_PARTITIONS)))

    def _next_partition(self, rr: Dict, domain_id: str, base: str,
                        task_type: int) -> int:
        key = (domain_id, base, task_type)
        with self._lock:
            n = rr.get(key, 0)
            rr[key] = n + 1
        return n % self._num_partitions(base)

    # -- adds (called by transfer-queue executors) -------------------------

    def _add_task(self, domain_id: str, base: str, task_type: int,
                  workflow_id: str, run_id: str, schedule_id: int,
                  partition: Optional[int] = None) -> None:
        """AddDecisionTask/AddActivityTask: pick a partition, sync-match
        locally, forward to root for sync-match, else persist locally."""
        p = (self._next_partition(self._add_rr, domain_id, base, task_type)
             if partition is None else partition)
        local = self._manager(domain_id, partition_name(base, p), task_type)
        # ForwardTask (forwarder.go:111): the root may have a parked poller
        # even when this partition doesn't; sync-or-persist is atomic
        # inside the manager
        root = (self._manager(domain_id, base, task_type) if p != 0 else None)
        local.add(domain_id, workflow_id, run_id, schedule_id, base=base,
                  forward_to=root)

    @tracing.traced(m.SCOPE_MATCHING_ADD_DECISION)
    def add_decision_task(self, domain_id: str, task_list: str,
                          workflow_id: str, run_id: str, schedule_id: int,
                          partition: Optional[int] = None) -> None:
        self._add_task(domain_id, task_list, TASK_LIST_TYPE_DECISION,
                       workflow_id, run_id, schedule_id, partition)

    def add_activity_task(self, domain_id: str, task_list: str,
                          workflow_id: str, run_id: str, schedule_id: int,
                          partition: Optional[int] = None) -> None:
        self._add_task(domain_id, task_list, TASK_LIST_TYPE_ACTIVITY,
                       workflow_id, run_id, schedule_id, partition)

    def add_query_task(self, domain_id: str, task_list: str,
                       workflow_id: str, run_id: str, query_id: str) -> None:
        """Dispatch a query-only task (matchingEngine QueryWorkflow);
        queries ride the ROOT partition."""
        self._manager(domain_id, task_list, TASK_LIST_TYPE_DECISION).add_query(
            domain_id, workflow_id, run_id, query_id)

    # -- polls (called by workers via frontend) ----------------------------

    def _poll_task(self, domain_id: str, base: str, task_type: int
                   ) -> Optional[Tuple[PersistedTask, str]]:
        """Pick a partition round-robin; an empty non-root partition
        forwards the poll to the root's backlog (ForwardPoll). As a last
        resort, sweep every EXISTING partition manager of this base — so
        tasks persisted on partitions beyond a lowered partition-count
        knob still drain instead of stranding. Returns (task, source
        partition name) so the caller can ack the right backlog."""
        p = self._next_partition(self._poll_rr, domain_id, base, task_type)
        src = partition_name(base, p)
        task = self._manager(domain_id, src, task_type).poll()
        if task is None and p != 0:
            src = base
            task = self._manager(domain_id, base, task_type).poll()
        if task is None:
            prefix = f"{PARTITION_PREFIX}{base}/"
            with self._lock:
                candidates = [(name, mgr)
                              for (d, name, t), mgr in self._managers.items()
                              if d == domain_id and t == task_type
                              and (name == base or name.startswith(prefix))]
            for name, mgr in candidates:
                task = mgr.poll()
                if task is not None:
                    src = name
                    break
        return None if task is None else (task, src)

    def _park(self, domain_id: str, task_list: str, task_type: int,
              partition: int) -> ParkedPoll:
        """Register a parked long-poll on a partition; an incoming task
        sync-matches into it (the poller arm of trySyncMatch).

        The backlog is drained FIRST — the partition's, then the root's
        (ForwardPoll) — so a park never waits while persisted work is
        available (and a task landing between a missed poll and the park
        can't be lost)."""
        poll = ParkedPoll()
        mgr = self._manager(domain_id, partition_name(task_list, partition),
                            task_type)
        root = (self._manager(domain_id, task_list, task_type)
                if partition != 0 else None)
        mgr.park_or_take(poll, task_list, fallback=root)
        if poll.task is None and self._num_partitions(task_list) > 1:
            # close the sibling-partition window: a task persisted to a
            # sibling BEFORE this park registered would otherwise sleep the
            # full long-poll timeout (adds after the park sync-match via the
            # root forward). Sweep existing siblings; if the poll matched
            # something else meanwhile, put the swept task back.
            prefix = f"{PARTITION_PREFIX}{task_list}/"
            with self._lock:
                siblings = [(name, m)
                            for (d, name, t), m in self._managers.items()
                            if d == domain_id and t == task_type
                            and (name == task_list or name.startswith(prefix))
                            and m is not mgr]
            for sib_name, sib in siblings:
                task = sib.poll()
                if task is None:
                    continue
                delivered = poll._try_deliver(MatchedTask(
                    domain_id=task.domain_id, workflow_id=task.workflow_id,
                    run_id=task.run_id, schedule_id=task.schedule_id,
                    task_list=task_list, task_id=task.task_id,
                    source=sib_name))
                if delivered and poll._unpark is not None:
                    poll._unpark()
                else:
                    sib.requeue_front(task)
                break
        return poll

    def park_for_decision_task(self, domain_id: str, task_list: str,
                               partition: int = 0) -> ParkedPoll:
        return self._park(domain_id, task_list, TASK_LIST_TYPE_DECISION,
                          partition)

    def park_for_activity_task(self, domain_id: str, task_list: str,
                               partition: int = 0) -> ParkedPoll:
        return self._park(domain_id, task_list, TASK_LIST_TYPE_ACTIVITY,
                          partition)

    def _record_poller(self, domain_id: str, task_list: str,
                       task_type: int, identity: str) -> None:
        """Poller-identity history (matching/pollerHistory.go): recent
        worker identities per task list, TTL'd by DescribeTaskList."""
        if not identity:
            return
        with self._lock:
            hist = self._pollers.setdefault((domain_id, task_list,
                                             task_type), {})
            hist[identity] = _time.time()
            if len(hist) > 64:  # bounded, oldest out
                oldest = min(hist, key=hist.get)
                del hist[oldest]

    def poll_for_decision_task(self, domain_id: str, task_list: str,
                               identity: str = ""
                               ) -> Optional[MatchedTask]:
        self._record_poller(domain_id, task_list, TASK_LIST_TYPE_DECISION,
                            identity)
        q = self._manager(domain_id, task_list,
                          TASK_LIST_TYPE_DECISION).poll_query()
        if q is not None:
            return MatchedTask(domain_id=q[0], workflow_id=q[1], run_id=q[2],
                               schedule_id=-1, task_list=task_list,
                               query_id=q[3])
        hit = self._poll_task(domain_id, task_list, TASK_LIST_TYPE_DECISION)
        if hit is None:
            return None
        task, src = hit
        return MatchedTask(domain_id=task.domain_id, workflow_id=task.workflow_id,
                           run_id=task.run_id, schedule_id=task.schedule_id,
                           task_list=task_list, task_id=task.task_id,
                           source=src)

    def poll_for_activity_task(self, domain_id: str, task_list: str,
                               identity: str = ""
                               ) -> Optional[MatchedTask]:
        self._record_poller(domain_id, task_list, TASK_LIST_TYPE_ACTIVITY,
                            identity)
        hit = self._poll_task(domain_id, task_list, TASK_LIST_TYPE_ACTIVITY)
        if hit is None:
            return None
        task, src = hit
        return MatchedTask(domain_id=task.domain_id, workflow_id=task.workflow_id,
                           run_id=task.run_id, schedule_id=task.schedule_id,
                           task_list=task_list, task_id=task.task_id,
                           source=src)

    @tracing.traced(m.SCOPE_MATCHING_POLL_DECISION)
    def poll_and_wait_decision(self, domain_id: str, task_list: str,
                               wait_seconds: float = 0, identity: str = ""
                               ) -> Optional[MatchedTask]:
        """Poll; on empty, park for sync-match up to `wait_seconds` (the
        long-poll composite — also the shape a long poll takes over the
        wire: the server blocks, no ParkedPoll object crosses processes)."""
        task = self.poll_for_decision_task(domain_id, task_list,
                                           identity=identity)
        if task is None and wait_seconds > 0:
            parked = self.park_for_decision_task(domain_id, task_list)
            parked.done.wait(wait_seconds)
            if parked.task is None:
                parked.cancel()
            task = parked.task
        return task

    def poll_and_wait_activity(self, domain_id: str, task_list: str,
                               wait_seconds: float = 0, identity: str = ""
                               ) -> Optional[MatchedTask]:
        task = self.poll_for_activity_task(domain_id, task_list,
                                           identity=identity)
        if task is None and wait_seconds > 0:
            parked = self.park_for_activity_task(domain_id, task_list)
            parked.done.wait(wait_seconds)
            if parked.task is None:
                parked.cancel()
            task = parked.task
        return task

    def requeue_task(self, task: MatchedTask, task_type: int) -> None:
        """Return a delivered-but-unprocessed task (the engine write behind
        it failed) to the FRONT of its source backlog — the reference only
        acks a matched task after successful delivery, so a failed
        RecordTaskStarted redelivers. The original persisted identity is
        kept: the store row was never deleted (two-phase ack), so the
        requeue is store-visible, not an in-memory synthetic."""
        mgr = self._manager(task.domain_id, task.source or task.task_list,
                            task_type)
        mgr.requeue_front(PersistedTask(
            task_id=task.task_id, domain_id=task.domain_id,
            workflow_id=task.workflow_id, run_id=task.run_id,
            schedule_id=task.schedule_id))

    def complete_task(self, task: MatchedTask, task_type: int) -> None:
        """Second phase of the ack: the engine write behind the delivery
        succeeded (or the task proved stale) — delete the persisted row.
        Sync-matched tasks (task_id 0) were never persisted; no-op."""
        if not task.task_id or not task.source:
            return
        self._manager(task.domain_id, task.source, task_type).complete(
            task.task_id)

    def describe_task_list(self, domain_id: str, task_list: str,
                           task_type: int) -> Dict[str, int]:
        """DescribeTaskList (workflowHandler.go:3593): aggregate over the
        base name's partitions."""
        total = 0
        for p in range(self._num_partitions(task_list)):
            key = (domain_id, partition_name(task_list, p), task_type)
            with self._lock:
                mgr = self._managers.get(key)
            if mgr is not None:
                total += mgr.backlog()
        with self._lock:
            hist = self._pollers.get((domain_id, task_list, task_type), {})
            cutoff = _time.time() - 300  # pollerHistory's 5-minute TTL
            pollers = [{"identity": ident, "last_access_time": ts}
                       for ident, ts in sorted(hist.items(),
                                               key=lambda kv: -kv[1])
                       if ts >= cutoff]
        return {"backlog": total,
                "partitions": self._num_partitions(task_list),
                "pollers": pollers}

    def backlog(self) -> int:
        with self._lock:
            managers = list(self._managers.values())
        return sum(m.backlog() for m in managers)
