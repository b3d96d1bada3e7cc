"""History engine: the active-side per-shard workflow state engine.

Reference: service/history/historyEngine.go (engine.Engine interface at
service/history/engine/interface.go:36) + decision/task_handler.go (decision
translation) + decision/handler.go (decision lifecycle).

Design note (TPU-first restructuring): the reference maintains two parallel
mutation paths — active `Add*Event` methods and passive `Replicate*Event`
methods — with the active path calling the passive one internally
(e.g. AddActivityTaskScheduledEvent → ReplicateActivityTaskScheduledEvent,
mutable_state_builder.go:2096-2139). This engine goes all the way: every
active transaction CONSTRUCTS its event batch, then applies it through the
same StateBuilder used for replay. Active state is therefore identical to
replayed state by construction, and the TPU kernel can verify any live
workflow by replaying its persisted history (see tpu_engine.py).

Each public method is one workflow transaction:
  load state → build event batch → apply (oracle semantics) → persist
  {history append, fenced conditional state update, shard task inserts}
mirroring context.UpdateWorkflowExecutionAsActive (execution/context.go:105).
"""
from __future__ import annotations

import copy
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..core.checksum import Checksum
from ..core.codec import serialize_history
from ..core.enums import (
    BUFFERED_EVENT_ID,
    EMPTY_EVENT_ID,
    TRANSIENT_EVENT_ID,
    CloseStatus,
    ContinueAsNewInitiator,
    DecisionType,
    EventType,
    TimeoutType,
    WorkflowState,
)
from ..core.events import HistoryBatch, HistoryEvent, RetryPolicy
from ..oracle import task_generator as taskgen
from ..oracle.mutable_state import DomainEntry, MutableState, ReplayError
from ..oracle.retry import retry_activity
from ..oracle.state_builder import StateBuilder
from ..utils import flightrecorder
from ..utils import metrics as m
from ..utils import tracing
from ..utils.clock import TimeSource
from ..utils.quotas import ServiceBusyError
from .persistence import DomainInfo, EntityNotExistsError, Stores
from .task_refresher import refresh_tasks as _refresh
from .shard import ShardContext


class InvalidRequestError(Exception):
    """BadRequestError analog (invalid decision/request for current state)."""


@dataclass
class TaskToken:
    """Opaque token tying a dispatched task to its workflow transaction
    (reference: common taskToken serialized into matching responses).

    `attempt` disambiguates transient activity attempts: every transient
    start reuses started_id == TRANSIENT_EVENT_ID, so without it a stale
    worker's response for a superseded attempt would be accepted (the
    reference token carries ScheduleAttempt for the same reason)."""

    domain_id: str
    workflow_id: str
    run_id: str
    schedule_id: int
    started_id: int = EMPTY_EVENT_ID
    attempt: int = 0


@dataclass
class Decision:
    """One worker decision (types.Decision analog)."""

    decision_type: DecisionType
    attrs: Dict[str, Any] = field(default_factory=dict)


class HistoryEngine:
    """Per-shard engine (historyEngineImpl analog)."""

    def __init__(self, shard: ShardContext, stores: Stores,
                 time_source: TimeSource) -> None:
        from ..utils.log import DEFAULT_LOGGER
        self.shard = shard
        self.stores = stores
        self.clock = time_source
        #: tagged structured logger (log/tag ShardID; loggerimpl.WithTags)
        self.log = DEFAULT_LOGGER.with_tags(component="history",
                                            shard_id=shard.shard_id)
        #: execution context cache (execution/cache.go:48): skips the full
        #: mutable-state store read on the transaction hot path, with
        #: store-version revalidation so foreign writers (replication,
        #: NDC, admin rebuild) are never served stale. Bounded LRU.
        from .cache import DomainCache, ExecutionCache
        self.execution_cache = ExecutionCache()
        self.domain_cache = DomainCache()
        #: shared holder so a cluster can attach its replication publisher to
        #: engines created before/after wiring ({"pub": ReplicationPublisher})
        self.replication_publisher_holder: Dict[str, Any] = {"pub": None}
        #: consistent-query registry (query/registry.go); the owning
        #: cluster replaces this with its shared instance
        from .query import QueryRegistry
        self.queries = QueryRegistry()
        #: cluster metrics + dynamic config; the owning cluster replaces
        #: these with its shared instances (onebox._make_engine)
        from ..utils.dynamicconfig import DynamicConfig
        from ..utils.metrics import DEFAULT_REGISTRY
        self.metrics = DEFAULT_REGISTRY
        self.config = DynamicConfig()
        #: history long-poll pub/sub (events/notifier.go); the owning
        #: cluster replaces this with its shared instance
        from .notifier import HistoryNotifier
        self.notifier = HistoryNotifier()
        #: device-serving transaction tier (engine/serving.py): when the
        #: owning cluster wires a ServingScheduler here, every COMMITTED
        #: transaction's batch is handed off for micro-batched from-state
        #: replay — the oracle stays the sole authority on legality, the
        #: device twin stays hot for the serving reads. None = tier off
        #: (the default; CADENCE_TPU_SERVING=1 wires it at cluster boot)
        self.serving = None
        #: where this engine's own device work runs (the reset rebuilder it
        #: builds when the cluster wires none); None = the card. The owning
        #: cluster sets it (onebox._make_engine)
        self.device = None
        #: the most recent handoff's ticket (tests and sync callers block
        #: on it; the handoff itself is fire-and-forget)
        self.last_serving_ticket = None

    def _replication_target(self, domain_id: str, ms: MutableState):
        """Shared gate for both replication publish paths: (publisher,
        source-branch version-history items), or None when the domain isn't
        global or no publisher is wired."""
        pub = self.replication_publisher_holder.get("pub")
        if pub is None:
            return None
        try:
            if len(self.stores.domain.by_id(domain_id).clusters) < 2:
                return None
        except EntityNotExistsError:
            return None
        items = tuple((i.event_id, i.version)
                      for i in ms.version_histories.current().items)
        return pub, items

    def _publish_replication(self, domain_id: str, workflow_id: str,
                             run_id: str, events, ms: MutableState) -> None:
        """insertReplicationTasks analog: global domains stream every
        committed batch to remote clusters, carrying the source branch's
        version-history items for NDC branch selection."""
        target = self._replication_target(domain_id, ms)
        if target is None:
            return
        pub, items = target
        pub.publish(domain_id, workflow_id, run_id, events,
                    version_history_items=items)

    def _publish_sync_activity(self, ms: MutableState, ai) -> None:
        """Stream one activity's transient attempt/failure state to
        standbys (syncActivityTasks analog; no history events exist for
        transient retries, so this is the only carrier)."""
        target = self._replication_target(ms.execution_info.domain_id, ms)
        if target is None:
            return
        pub, items = target
        pub.publish_sync_activity(ms, ai, items)

    # ------------------------------------------------------------------
    # transaction plumbing
    # ------------------------------------------------------------------

    def _domain_entry(self, domain_id: str) -> DomainEntry:
        try:
            # DomainCache (common/cache/domainCache.go): revalidated
            # against the store's mutation counter, so UpdateDomain and
            # failovers surface on the next transaction
            d = self.domain_cache.by_id(self.stores, domain_id)
            return DomainEntry(domain_id=d.domain_id, name=d.name,
                               is_active=d.is_active,
                               retention_days=d.retention_days,
                               failover_version=d.failover_version)
        except EntityNotExistsError:
            return DomainEntry(domain_id=domain_id, is_active=True)

    def _load(self, domain_id: str, workflow_id: str,
              run_id: Optional[str] = None) -> Tuple[MutableState, int]:
        if run_id is None:
            run_id = self.stores.execution.get_current_run_id(domain_id, workflow_id)
        # context cache first (execution/cache.go GetOrCreate): a hit is
        # already a PRIVATE copy revalidated against the store version
        ms = self.execution_cache.load(self.stores, domain_id, workflow_id,
                                       run_id)
        if ms is None:
            ms = self.stores.execution.get_workflow(domain_id, workflow_id,
                                                    run_id)
            # work on a copy so a failed transaction never corrupts the store
            ms = copy.deepcopy(ms)
        # refresh the domain entry: StartTransaction re-reads the failover
        # version so post-failover events carry the new version
        # (mutable_state_builder.go:3941-3947)
        ms.domain_entry = self._domain_entry(domain_id)
        return ms, ms.execution_info.next_event_id

    def _new_transaction(self, ms: MutableState) -> "_Txn":
        return _Txn(self, ms)

    def _hand_to_serving(self, ms: MutableState, events_blob: bytes,
                         batch: Optional[HistoryBatch] = None) -> None:
        """Hand one COMMITTED transaction to the device-serving tier
        (engine/serving.py): the oracle's post-commit payload row, the
        committed batch's CRC32 (the content-address tail the drain uses
        to prove the store still ends at this transaction), and the
        committed batch ITSELF — with it a chained append flushes with
        zero store reads. Fire and forget — queue-full backpressure is
        counted and skipped, never a transaction failure: the oracle
        state is already durable, only the device twin lags (it catches
        up on the next transaction's suffix lookup)."""
        import zlib

        from ..core.checksum import STICKY_ROW_INDEX, payload_row

        serving = self.serving
        if serving is None:
            return
        info = ms.execution_info
        key = (info.domain_id, info.workflow_id, info.run_id)
        try:
            row = payload_row(ms, serving.layout)
            # sticky state is active-side only; replay clears it
            row[STICKY_ROW_INDEX] = 0
            self.last_serving_ticket = serving.submit(
                key, row, int(ms.version_histories.current_index),
                zlib.crc32(events_blob), batch=batch)
        except ServiceBusyError:
            self.last_serving_ticket = None
        except Exception:
            self.last_serving_ticket = None
            self.log.warning("serving handoff failed",
                             workflow_id=info.workflow_id)

    # ------------------------------------------------------------------
    # Buffered events (mutable_state_builder.go:112-114 bufferedEvents;
    # FlushBufferedEvents :415): while a decision is IN FLIGHT (started,
    # not closed), externally-caused events are buffered in mutable state
    # with no history IDs; at decision close they flush — IDs assigned
    # after the close event, activity/child COMPLETION events reordered to
    # the back (reorderBuffer) so their started counterparts precede them.
    # ------------------------------------------------------------------

    #: completion events moved to the back of the flush (reorderBuffer)
    _REORDER_TYPES = frozenset({
        EventType.ActivityTaskCompleted, EventType.ActivityTaskFailed,
        EventType.ActivityTaskTimedOut, EventType.ActivityTaskCanceled,
        EventType.ChildWorkflowExecutionCompleted,
        EventType.ChildWorkflowExecutionFailed,
        EventType.ChildWorkflowExecutionTimedOut,
        EventType.ChildWorkflowExecutionTerminated,
        EventType.ChildWorkflowExecutionCanceled,
    })
    _ACTIVITY_CLOSE_TYPES = frozenset({
        EventType.ActivityTaskCompleted, EventType.ActivityTaskFailed,
        EventType.ActivityTaskTimedOut, EventType.ActivityTaskCanceled,
    })

    @staticmethod
    def _has_inflight_decision(ms: MutableState) -> bool:
        return ms.execution_info.decision_started_id != EMPTY_EVENT_ID

    def _buffer_event(self, ms: MutableState, expected: int,
                      event_type: EventType, **attrs: Any) -> None:
        """Append one buffered event and persist state WITHOUT appending
        history (the updateBufferedEvents arm of CloseTransaction). Runs
        the timer sequence like every transaction close, so e.g. a
        buffered activity start still creates its timeout timers."""
        ms.buffered_events.append(HistoryEvent(
            id=BUFFERED_EVENT_ID, event_type=event_type,
            version=ms.domain_entry.failover_version,
            timestamp=self.clock.now(), attrs=attrs))
        self._commit_transient(ms, expected)

    def _buffered_close_exists(self, ms: MutableState, **match: Any) -> bool:
        """True when a buffered event already closes the same entity (the
        pending-info maps don't shrink until flush, so double-respond
        validation must consult the buffer too)."""
        for ev in ms.buffered_events:
            if all(ev.get(k) == v for k, v in match.items()):
                if ev.event_type in self._REORDER_TYPES or ev.event_type in (
                        EventType.TimerFired, EventType.TimerCanceled):
                    return True
        return False

    def _flush_and_reschedule(self, txn: "_Txn", ms: MutableState,
                              sticky: bool = False) -> int:
        """Flush the buffer after a decision fail/timeout close event and,
        when anything flushed, append a REAL scheduled event (attempt 0) —
        a transient's provisional schedule ID would collide with the
        flushed events' IDs (mutable_state_decision_task_manager.go:373-382).
        The replay of the close event still momentarily creates a transient
        whose dispatch task would be stale; txn.commit drops it (the
        reference's active side never creates it at all)."""
        info = ms.execution_info
        flushed = self._flush_buffered(txn, ms)
        if flushed:
            txn.add(EventType.DecisionTaskScheduled,
                    task_list=(info.sticky_task_list or info.task_list)
                    if sticky else info.task_list,
                    start_to_close_timeout_seconds=info.decision_start_to_close_timeout,
                    attempt=0)
            txn.drop_stale_decision_tasks = True
        return flushed

    def _flush_buffered(self, txn: "_Txn", ms: MutableState) -> int:
        """Assign real event IDs to the buffer, completion events last;
        started-event references recorded as BUFFERED_EVENT_ID are patched
        to the flushed IDs (the reference's buffered-event-ID scrubbing)."""
        if not ms.buffered_events:
            return 0
        normal = [e for e in ms.buffered_events
                  if e.event_type not in self._REORDER_TYPES]
        closes = [e for e in ms.buffered_events
                  if e.event_type in self._REORDER_TYPES]
        ms.buffered_events = []
        flushed_started: Dict[int, int] = {}
        flushed_child_started: Dict[int, int] = {}
        for ev in normal + closes:
            attrs = dict(ev.attrs)
            if attrs.get("started_event_id") == BUFFERED_EVENT_ID:
                if ev.event_type in self._ACTIVITY_CLOSE_TYPES:
                    attrs["started_event_id"] = flushed_started.get(
                        attrs.get("scheduled_event_id"), BUFFERED_EVENT_ID)
                else:  # child close: link to the flushed child started
                    attrs["started_event_id"] = flushed_child_started.get(
                        attrs.get("initiated_event_id"), BUFFERED_EVENT_ID)
            real = txn.add_flushed(ev, attrs)
            if ev.event_type == EventType.ActivityTaskStarted:
                flushed_started[attrs.get("scheduled_event_id")] = real.id
            elif ev.event_type == EventType.ChildWorkflowExecutionStarted:
                flushed_child_started[attrs.get("initiated_event_id")] = real.id
        self.metrics.inc(m.SCOPE_HISTORY_DECISION_COMPLETED,
                         m.M_BUFFERED_FLUSHED, len(normal) + len(closes))
        return len(normal) + len(closes)

    # ------------------------------------------------------------------
    # StartWorkflowExecution (historyEngine.go:547, startWorkflowHelper:583)
    # ------------------------------------------------------------------

    @tracing.traced(m.SCOPE_HISTORY_START_WORKFLOW)
    def start_workflow(self, domain_id: str, workflow_id: str,
                       workflow_type: str, task_list: str,
                       execution_timeout: int = 3600,
                       decision_timeout: int = 10,
                       input_payload: bytes = b"",
                       cron_schedule: str = "",
                       first_decision_backoff: int = 0,
                       retry_policy: Optional[RetryPolicy] = None,
                       parent: Optional[Dict[str, Any]] = None,
                       request_id: Optional[str] = None,
                       run_id: Optional[str] = None,
                       initiator: Optional[ContinueAsNewInitiator] = None,
                       attempt: int = 0,
                       expiration_timestamp: int = 0,
                       initial_signals: Sequence[Union[str, Tuple[str, Optional[str]]]]
                       = ()) -> str:
        self.metrics.inc(m.SCOPE_HISTORY_START_WORKFLOW, m.M_REQUESTS)
        run_id = run_id or str(uuid.uuid4())
        # duplicate check BEFORE any write (the create fence still guards
        # the race): a rejected duplicate must not leave orphan history
        try:
            cur = self.stores.execution.get_current_run_id(domain_id,
                                                           workflow_id)
            cur_ms = self.stores.execution.get_workflow(domain_id,
                                                        workflow_id, cur)
            if cur_ms.execution_info.state != WorkflowState.Completed:
                from .persistence import WorkflowAlreadyStartedError
                raise WorkflowAlreadyStartedError(
                    f"{workflow_id}: run {cur} still open")
        except EntityNotExistsError:
            pass
        ms = MutableState(self._domain_entry(domain_id))
        version = ms.domain_entry.failover_version
        now = self.clock.now()
        start_attrs: Dict[str, Any] = dict(
            task_list=task_list, workflow_type=workflow_type,
            execution_start_to_close_timeout_seconds=execution_timeout,
            task_start_to_close_timeout_seconds=decision_timeout,
            first_execution_run_id=run_id,
        )
        if cron_schedule:
            start_attrs["cron_schedule"] = cron_schedule
        if first_decision_backoff > 0:
            start_attrs["first_decision_task_backoff_seconds"] = first_decision_backoff
        if retry_policy is not None:
            start_attrs["retry_policy"] = retry_policy
            if expiration_timestamp == 0 and retry_policy.expiration_interval_seconds:
                # the deadline runs from the first decision schedule to the
                # end of the workflow, so a delayed first decision extends it
                # (mutable_state_builder.go:1646-1652)
                expiration_timestamp = now + (
                    retry_policy.expiration_interval_seconds
                    + first_decision_backoff) * 1_000_000_000
        if initiator is not None:
            start_attrs["initiator"] = int(initiator)
        if attempt:
            start_attrs["attempt"] = attempt
        if expiration_timestamp:
            start_attrs["expiration_timestamp"] = expiration_timestamp
        if parent:
            start_attrs.update(parent)

        events = [
            HistoryEvent(id=1, event_type=EventType.WorkflowExecutionStarted,
                         version=version, timestamp=now, attrs=start_attrs),
        ]
        # SignalWithStart: the signal events land in the START transaction,
        # before the first decision schedule (historyEngine.go
        # SignalWithStartWorkflowExecution orders started→signaled→decision)
        for sig in initial_signals:
            # (name, request_id) pairs ride the dedup set from birth: a
            # SignalWithStart retried after the start committed must
            # no-op its signal arm, not double-deliver (plain names stay
            # accepted for callers without a request id)
            sig_name, sig_rid = (sig if isinstance(sig, tuple)
                                 else (sig, None))
            sig_attrs: Dict[str, Any] = dict(signal_name=sig_name)
            if sig_rid:
                sig_attrs["request_id"] = sig_rid
            events.append(HistoryEvent(
                id=len(events) + 1,
                event_type=EventType.WorkflowExecutionSignaled,
                version=version, timestamp=now,
                attrs=sig_attrs))
        # generateFirstDecisionTask (historyEngine.go:529) unless delayed
        if first_decision_backoff <= 0:
            events.append(HistoryEvent(
                id=len(events) + 1, event_type=EventType.DecisionTaskScheduled,
                version=version, timestamp=now,
                attrs=dict(task_list=task_list,
                           start_to_close_timeout_seconds=decision_timeout,
                           attempt=0),
            ))
        batch = HistoryBatch(domain_id=domain_id, workflow_id=workflow_id,
                             run_id=run_id, events=events,
                             request_id=request_id or str(uuid.uuid4()))
        sb = StateBuilder(ms)
        sb.apply_batch(batch)
        # the start batch counts toward history size like every later
        # transaction's; the bytes double as the WAL record's blob
        start_blob = serialize_history([batch])
        ms.history_size = len(start_blob)

        # history FIRST (the reference's events-first ordering,
        # context.go PersistStartWorkflowBatchEvents before
        # CreateWorkflowExecution): a failure between the two leaves only
        # orphan history under a never-registered run ID — harmless; the
        # execution row is the commit point, so a retried start (fresh run
        # ID) starts clean
        self.shard.append_history(domain_id, workflow_id, run_id, events,
                                  blob=start_blob)
        self.shard.insert_tasks(domain_id, workflow_id, run_id,
                                ms.transfer_tasks, ms.timer_tasks)
        self.shard.create_workflow(ms)  # commit point
        ms.transfer_tasks, ms.timer_tasks = [], []
        self._publish_replication(domain_id, workflow_id, run_id, events, ms)
        self.notifier.notify((domain_id, workflow_id, run_id),
                             ms.execution_info.next_event_id, False)
        # the start batch seeds the device twin like any other committed
        # transaction (cold admit on the serving tier's next drain)
        self._hand_to_serving(ms, start_blob, batch)
        return run_id

    # ------------------------------------------------------------------
    # Decision task lifecycle (decision/handler.go)
    # ------------------------------------------------------------------

    @tracing.traced(m.SCOPE_HISTORY_RECORD_STARTED)
    def record_decision_task_started(self, domain_id: str, workflow_id: str,
                                     run_id: str, schedule_id: int,
                                     request_id: str) -> TaskToken:
        """HandleDecisionTaskStarted (decision/handler.go).

        Transient decisions (attempt > 0 after a failed/timed-out decision)
        exist only in mutable state until picked up; on start the real
        scheduled+started pair is written as one batch — the two-batch
        "transaction" described at mutable_state_decision_task_manager.go:215-223
        — and ReplicateDecisionTaskScheduledEvent overwrites the transient's
        provisional schedule ID (:180-182)."""
        ms, expected = self._load(domain_id, workflow_id, run_id)
        info = ms.execution_info
        if info.state == WorkflowState.Completed:
            # checkMutability analog (mutable_state_builder.go checkMutability)
            raise InvalidRequestError("workflow execution already completed")
        if info.decision_schedule_id != schedule_id:
            raise InvalidRequestError(
                f"decision {schedule_id} not pending (have {info.decision_schedule_id})"
            )
        if info.decision_started_id != EMPTY_EVENT_ID:
            raise InvalidRequestError("decision already started")
        txn = self._new_transaction(ms)
        if info.decision_attempt > 0:
            sched = txn.add(EventType.DecisionTaskScheduled,
                            task_list=info.task_list,
                            start_to_close_timeout_seconds=info.decision_timeout,
                            attempt=info.decision_attempt)
            schedule_id = sched.id
        started = txn.add(EventType.DecisionTaskStarted,
                          scheduled_event_id=schedule_id, request_id=request_id)
        txn.commit(expected)
        return TaskToken(domain_id=domain_id, workflow_id=workflow_id,
                         run_id=run_id, schedule_id=schedule_id,
                         started_id=started.id)

    #: decisions that close the workflow (UnhandledDecision check)
    _CLOSE_DECISIONS = frozenset({
        DecisionType.CompleteWorkflowExecution,
        DecisionType.FailWorkflowExecution,
        DecisionType.CancelWorkflowExecution,
        DecisionType.ContinueAsNewWorkflowExecution,
    })

    @tracing.traced(m.SCOPE_HISTORY_DECISION_COMPLETED)
    def respond_decision_task_completed(self, token: TaskToken,
                                        decisions: List[Decision],
                                        sticky_task_list: str = "",
                                        sticky_schedule_to_start_timeout: int = 0,
                                        query_results: Optional[Dict[str, bytes]] = None
                                        ) -> None:
        """RespondDecisionTaskCompleted (historyEngine.go:1787 →
        decision/handler.go:285, per-decision translation per
        decision/task_handler.go).

        Buffered events: a close decision racing buffered events fails
        with UNHANDLED_DECISION so the worker re-decides with the new
        events visible (historyEngine.go hasUnhandledEventsBeforeDecision);
        otherwise the buffer flushes right behind the completed event and,
        when anything flushed, a fresh decision is scheduled.

        Sticky execution: StickyAttributes on the response pin the next
        decision dispatch to the worker's sticky task list; absent
        attributes clear stickyness (workflowHandler →
        historyEngine.go RespondDecisionTaskCompleted sticky handling)."""
        self.metrics.inc(m.SCOPE_HISTORY_DECISION_COMPLETED, m.M_REQUESTS)
        ms, expected = self._load(token.domain_id, token.workflow_id, token.run_id)
        info = ms.execution_info
        if info.state == WorkflowState.Completed:
            raise InvalidRequestError("workflow execution already completed")
        if (info.decision_schedule_id != token.schedule_id
                or info.decision_started_id != token.started_id):
            raise InvalidRequestError("decision task no longer current")

        # queries attached to this decision complete regardless of the
        # decision outcome; unanswered started queries re-buffer for the
        # next decision (historyEngine query-result reconciliation)
        qkey = (token.domain_id, token.workflow_id, token.run_id)
        for qid, qres in (query_results or {}).items():
            self.queries.complete(qkey, qid, qres)
        self.queries.requeue_started(qkey)

        # attribute validation FIRST (decision/checker.go): one malformed
        # decision fails the whole decision task with a typed cause and
        # the worker re-decides — never a replay-transaction crash
        from ..utils.dynamicconfig import KEY_BLOB_SIZE_LIMIT_ERROR
        from .checker import BadDecisionAttributes, validate_decision
        blob_limit = int(self.config.get(KEY_BLOB_SIZE_LIMIT_ERROR,
                                         domain=ms.domain_entry.name) or 0)
        fail_cause = None
        try:
            for d in decisions:
                validate_decision(d, info.workflow_timeout,
                                  blob_size_limit=blob_limit)
        except BadDecisionAttributes as bad:
            fail_cause = bad.cause
        if fail_cause is None and ms.buffered_events and any(
                d.decision_type in self._CLOSE_DECISIONS for d in decisions):
            # UnhandledDecision: the close must not race the buffer
            fail_cause = "UNHANDLED_DECISION"
        if fail_cause is not None:
            # the flushed events force a REAL follow-up decision (attempt
            # 0, mutable_state_decision_task_manager.go:373-382)
            txn = self._new_transaction(ms)
            txn.add(EventType.DecisionTaskFailed,
                    scheduled_event_id=token.schedule_id,
                    started_event_id=token.started_id,
                    cause=fail_cause)
            self._flush_and_reschedule(txn, ms)
            txn.commit(expected)
            return

        if sticky_task_list:
            info.sticky_task_list = sticky_task_list
            info.sticky_schedule_to_start_timeout = (
                sticky_schedule_to_start_timeout)
        else:
            ms.clear_stickyness()

        txn = self._new_transaction(ms)
        completed = txn.add(EventType.DecisionTaskCompleted,
                            scheduled_event_id=token.schedule_id,
                            started_event_id=token.started_id)
        closed = False
        for d in decisions:
            closed = self._apply_decision(txn, ms, completed.id, d) or closed
            if closed:
                break
        # buffered events flush at transaction close, BEHIND the decision's
        # command events (FlushBufferedEvents runs in CloseTransaction,
        # mutable_state_builder.go:4150); a close decision cannot reach
        # here with a non-empty buffer (UnhandledDecision above)
        flushed = self._flush_buffered(txn, ms)
        if flushed and not closed:
            # the flushed events need a decision to process them (the
            # completed event above clears the pending decision, so this
            # schedules unconditionally — hasUnhandledEvents arm of
            # historyEngine RespondDecisionTaskCompleted)
            txn.add(EventType.DecisionTaskScheduled,
                    task_list=info.sticky_task_list or info.task_list,
                    start_to_close_timeout_seconds=info.decision_start_to_close_timeout,
                    attempt=0)
        txn.commit(expected)
        if closed:
            self.queries.fail_all(qkey, "workflow execution closed")
        # continue-as-new chaining is handled inside _apply_decision

    def _apply_decision(self, txn: "_Txn", ms: MutableState,
                        completed_id: int, d: Decision) -> bool:
        """One decision → events (decision/task_handler.go switch). Returns
        True when the decision closes the workflow."""
        a = d.attrs
        dt = d.decision_type
        if dt == DecisionType.ScheduleActivityTask:
            aid = a.get("activity_id")
            # check both committed state and this batch's earlier decisions
            # (decision/checker.go validates per-request, not just per-state)
            if (aid in ms.pending_activity_id_to_event_id
                    or aid in txn.added_activity_ids):
                raise InvalidRequestError(f"duplicate activity {aid}")
            txn.added_activity_ids.add(aid)
            txn.add(EventType.ActivityTaskScheduled,
                    decision_task_completed_event_id=completed_id, **a)
        elif dt == DecisionType.StartTimer:
            tid = a.get("timer_id")
            if tid in ms.pending_timer_info_ids or tid in txn.added_timer_ids:
                raise InvalidRequestError(f"duplicate timer {tid}")
            txn.added_timer_ids.add(tid)
            txn.add(EventType.TimerStarted,
                    decision_task_completed_event_id=completed_id, **a)
        elif dt == DecisionType.CancelTimer:
            if a.get("timer_id") not in ms.pending_timer_info_ids:
                raise InvalidRequestError(f"unknown timer {a.get('timer_id')}")
            ti = ms.pending_timer_info_ids[a["timer_id"]]
            # a fire buffered behind this decision loses to the cancel: the
            # buffered TimerFired is scrubbed so the flush doesn't replay a
            # fire for a timer the cancel deletes (checkAndClearTimerFiredEvent,
            # mutable_state_builder.go:588-604)
            ms.buffered_events = [
                e for e in ms.buffered_events
                if not (e.event_type == EventType.TimerFired
                        and e.get("timer_id") == a["timer_id"])]
            txn.add(EventType.TimerCanceled, timer_id=a["timer_id"],
                    started_event_id=ti.started_id,
                    decision_task_completed_event_id=completed_id)
        elif dt == DecisionType.RequestCancelActivityTask:
            sched = ms.pending_activity_id_to_event_id.get(a.get("activity_id"))
            if sched is None:
                txn.add(EventType.RequestCancelActivityTaskFailed,
                        activity_id=a.get("activity_id"),
                        cause="ACTIVITY_ID_UNKNOWN",
                        decision_task_completed_event_id=completed_id)
            else:
                txn.add(EventType.ActivityTaskCancelRequested,
                        activity_id=a.get("activity_id"),
                        decision_task_completed_event_id=completed_id)
        elif dt == DecisionType.RecordMarker:
            txn.add(EventType.MarkerRecorded,
                    decision_task_completed_event_id=completed_id, **a)
        elif dt == DecisionType.UpsertWorkflowSearchAttributes:
            txn.add(EventType.UpsertWorkflowSearchAttributes,
                    decision_task_completed_event_id=completed_id, **a)
        elif dt == DecisionType.StartChildWorkflowExecution:
            txn.add(EventType.StartChildWorkflowExecutionInitiated,
                    decision_task_completed_event_id=completed_id, **a)
        elif dt == DecisionType.SignalExternalWorkflowExecution:
            txn.add(EventType.SignalExternalWorkflowExecutionInitiated,
                    decision_task_completed_event_id=completed_id, **a)
        elif dt == DecisionType.RequestCancelExternalWorkflowExecution:
            txn.add(EventType.RequestCancelExternalWorkflowExecutionInitiated,
                    decision_task_completed_event_id=completed_id, **a)
        elif dt == DecisionType.CompleteWorkflowExecution:
            # cron workflows re-run instead of closing
            # (task_handler.go:436-460 handleDecisionCompleteWorkflow)
            cron_backoff = self._cron_backoff_seconds(ms)
            if cron_backoff >= 0:
                self._retry_cron_continue(
                    txn, ms, completed_id, a, cron_backoff,
                    ContinueAsNewInitiator.CronSchedule)
                return True
            txn.add(EventType.WorkflowExecutionCompleted,
                    decision_task_completed_event_id=completed_id, **a)
            return True
        elif dt == DecisionType.FailWorkflowExecution:
            # workflow retry policy first, then cron
            # (task_handler.go:517-545 handleDecisionFailWorkflow)
            backoff, initiator = self._workflow_retry_backoff_seconds(
                ms, a.get("reason", ""))
            if backoff < 0:
                backoff = self._cron_backoff_seconds(ms)
                initiator = ContinueAsNewInitiator.CronSchedule
            if backoff >= 0:
                self._retry_cron_continue(txn, ms, completed_id, a, backoff,
                                          initiator)
                return True
            txn.add(EventType.WorkflowExecutionFailed,
                    decision_task_completed_event_id=completed_id, **a)
            return True
        elif dt == DecisionType.CancelWorkflowExecution:
            txn.add(EventType.WorkflowExecutionCanceled,
                    decision_task_completed_event_id=completed_id, **a)
            return True
        elif dt == DecisionType.ContinueAsNewWorkflowExecution:
            self._continue_as_new(txn, ms, completed_id, a)
            return True
        else:
            raise InvalidRequestError(f"unknown decision type {dt}")
        return False

    def _cron_backoff_seconds(self, ms: MutableState) -> int:
        """GetCronBackoffDuration analog: seconds until the next cron run
        measured from now, or -1 (backoff/cron.go:48). The schedule anchors
        at the EXECUTION time — start + first-decision backoff
        (mutable_state_builder.go:1062-1072) — so a run closing exactly at
        its own fire time doesn't re-fire the same slot."""
        from ..utils.backoff import NO_BACKOFF, get_backoff_for_next_schedule
        info = ms.execution_info
        if not info.cron_schedule:
            return NO_BACKOFF
        anchor = info.start_timestamp \
            + info.first_decision_backoff * 1_000_000_000
        return get_backoff_for_next_schedule(
            info.cron_schedule, anchor, self.clock.now())

    def _workflow_retry_backoff_seconds(self, ms: MutableState,
                                        failure_reason: str):
        """Workflow-level retry backoff on FailWorkflow (retry.go math over
        ExecutionInfo's retry fields)."""
        from ..utils.backoff import NO_BACKOFF, get_backoff_interval
        info = ms.execution_info
        if not info.has_retry_policy:
            return NO_BACKOFF, ContinueAsNewInitiator.RetryPolicy
        backoff_nanos = get_backoff_interval(
            now_nanos=self.clock.now(),
            expiration_time_nanos=info.expiration_time,
            curr_attempt=info.attempt,
            max_attempts=info.maximum_attempts,
            init_interval_seconds=info.initial_interval,
            max_interval_seconds=info.maximum_interval,
            backoff_coefficient=info.backoff_coefficient,
            failure_reason=failure_reason,
            non_retriable_errors=info.non_retriable_errors,
        )
        if backoff_nanos == NO_BACKOFF:
            return NO_BACKOFF, ContinueAsNewInitiator.RetryPolicy
        return backoff_nanos // 1_000_000_000, ContinueAsNewInitiator.RetryPolicy

    def _retry_cron_continue(self, txn: "_Txn", ms: MutableState,
                             completed_id: int, attrs: Dict[str, Any],
                             backoff_seconds: int,
                             initiator: ContinueAsNewInitiator) -> None:
        """retryCronContinueAsNew (task_handler.go:456,:545): chain the next
        run with the computed backoff and initiator."""
        chained = dict(attrs)
        chained["backoff_start_interval_seconds"] = backoff_seconds
        chained["initiator"] = initiator
        if initiator == ContinueAsNewInitiator.RetryPolicy:
            chained["attempt"] = ms.execution_info.attempt + 1
        self._continue_as_new(txn, ms, completed_id, chained)

    def _continue_as_new(self, txn: "_Txn", ms: MutableState,
                         completed_id: int, attrs: Dict[str, Any]) -> None:
        """AddContinueAsNewEvent (mutable_state_builder.go:3269-3341): close
        this run and start the chained run in the same commit."""
        info = ms.execution_info
        new_run_id = str(uuid.uuid4())
        txn.add(EventType.WorkflowExecutionContinuedAsNew,
                new_execution_run_id=new_run_id,
                decision_task_completed_event_id=completed_id)
        txn.after_commit(lambda: self._start_continued_run(ms, new_run_id, attrs))

    def _start_continued_run(self, old_ms: MutableState, new_run_id: str,
                             attrs: Dict[str, Any]) -> None:
        info = old_ms.execution_info
        backoff = attrs.get("backoff_start_interval_seconds", 0) or 0
        retry_policy = attrs.get("retry_policy")
        if retry_policy is None and info.has_retry_policy:
            # retry/cron chains keep the original policy
            retry_policy = RetryPolicy(
                initial_interval_seconds=info.initial_interval,
                backoff_coefficient=info.backoff_coefficient,
                maximum_interval_seconds=info.maximum_interval,
                maximum_attempts=info.maximum_attempts,
                expiration_interval_seconds=info.expiration_seconds,
                non_retriable_error_reasons=list(info.non_retriable_errors),
            )
        self.start_workflow(
            domain_id=info.domain_id,
            workflow_id=info.workflow_id,
            workflow_type=info.workflow_type_name,
            task_list=attrs.get("task_list", info.task_list),
            execution_timeout=attrs.get(
                "execution_start_to_close_timeout_seconds", info.workflow_timeout),
            decision_timeout=attrs.get(
                "task_start_to_close_timeout_seconds",
                info.decision_start_to_close_timeout),
            cron_schedule=info.cron_schedule,
            first_decision_backoff=backoff,
            retry_policy=retry_policy,
            initiator=attrs.get("initiator"),
            attempt=attrs.get("attempt", 0) or 0,
            # only a RetryPolicy chain shares the FIRST run's expiration
            # deadline; cron/decider chains recompute it from now so retries
            # aren't silently disabled once the original deadline passes
            # (mutable_state_builder.go:1646-1661)
            expiration_timestamp=(
                info.expiration_time
                if attrs.get("initiator") == ContinueAsNewInitiator.RetryPolicy
                else 0),
            request_id=f"can-{new_run_id}",
            # the continued run keeps the workflow ID and MUST use the run ID
            # recorded in the ContinuedAsNew event, or the persisted chain
            # would point at a nonexistent run
            run_id=new_run_id,
        )

    def fail_decision_task(self, token: TaskToken, cause: str) -> None:
        """RespondDecisionTaskFailed path.

        With buffered events, the follow-up decision cannot be a transient
        (its provisional schedule ID would collide with the flushed events'
        IDs — mutable_state_decision_task_manager.go:373-382), so the
        buffer flushes and a REAL scheduled event follows with attempt 0."""
        ms, expected = self._load(token.domain_id, token.workflow_id, token.run_id)
        txn = self._new_transaction(ms)
        txn.add(EventType.DecisionTaskFailed,
                scheduled_event_id=token.schedule_id,
                started_event_id=token.started_id, cause=cause)
        self._flush_and_reschedule(txn, ms)
        txn.commit(expected)
        # queries attached to the failed decision ride the next one
        self.queries.requeue_started(
            (token.domain_id, token.workflow_id, token.run_id))

    # ------------------------------------------------------------------
    # Activity task lifecycle
    # ------------------------------------------------------------------

    def record_activity_task_started(self, domain_id: str, workflow_id: str,
                                     run_id: str, schedule_id: int,
                                     request_id: str) -> TaskToken:
        """AddActivityTaskStartedEvent (mutable_state_builder.go:2218).

        Activities WITH a retry policy start transiently: no started event
        is written yet (a failure may retry without ever recording it);
        mutable state alone tracks the attempt, and the started event is
        flushed when the activity finally closes (:2239-2251)."""
        ms, expected = self._load(domain_id, workflow_id, run_id)
        if ms.execution_info.state == WorkflowState.Completed:
            raise InvalidRequestError("workflow execution already completed")
        ai = ms.pending_activity_info_ids.get(schedule_id)
        if ai is None:
            raise InvalidRequestError(f"activity {schedule_id} not pending")
        if ai.started_id != EMPTY_EVENT_ID:
            raise InvalidRequestError(f"activity {schedule_id} already started")
        if ai.has_retry_policy:
            now = self.clock.now()
            ai.version = ms.current_version
            ai.started_id = TRANSIENT_EVENT_ID
            ai.request_id = request_id
            ai.started_time = now
            ai.last_heartbeat_updated_time = now
            self._commit_transient(ms, expected)
            self._publish_sync_activity(ms, ai)
            return TaskToken(domain_id=domain_id, workflow_id=workflow_id,
                             run_id=run_id, schedule_id=schedule_id,
                             started_id=TRANSIENT_EVENT_ID,
                             attempt=ai.attempt)
        if self._has_inflight_decision(ms):
            # the started event buffers (mutable_state_builder.go:2218
            # hasPendingDecision arm): state records the start immediately
            # with the buffered sentinel; the real ID lands at flush
            now = self.clock.now()
            ai.version = ms.current_version
            ai.started_id = BUFFERED_EVENT_ID
            ai.request_id = request_id
            ai.started_time = now
            ai.last_heartbeat_updated_time = now
            self._buffer_event(ms, expected, EventType.ActivityTaskStarted,
                               scheduled_event_id=schedule_id,
                               request_id=request_id)
            return TaskToken(domain_id=domain_id, workflow_id=workflow_id,
                             run_id=run_id, schedule_id=schedule_id,
                             started_id=BUFFERED_EVENT_ID)
        txn = self._new_transaction(ms)
        started = txn.add(EventType.ActivityTaskStarted,
                          scheduled_event_id=schedule_id, request_id=request_id)
        txn.commit(expected)
        return TaskToken(domain_id=domain_id, workflow_id=workflow_id,
                         run_id=run_id, schedule_id=schedule_id,
                         started_id=started.id)

    def _buffer_transient_started(self, ms: MutableState, ai,
                                  schedule_id: int) -> None:
        """Move a TRANSIENT activity start into the buffer (the activity is
        closing while a decision is in flight, so its deferred started
        event buffers ahead of the close)."""
        if ai.started_id != TRANSIENT_EVENT_ID:
            return
        ms.buffered_events.append(HistoryEvent(
            id=BUFFERED_EVENT_ID,
            event_type=EventType.ActivityTaskStarted,
            version=ms.domain_entry.failover_version,
            timestamp=ai.started_time or self.clock.now(),
            attrs=dict(scheduled_event_id=schedule_id,
                       attempt=ai.attempt, request_id=ai.request_id,
                       last_failure_reason=ai.last_failure_reason)))
        ai.started_id = BUFFERED_EVENT_ID

    @staticmethod
    def _flush_transient_started(txn: "_Txn", ms: MutableState,
                                 schedule_id: int) -> Optional[HistoryEvent]:
        """addTransientActivityStartedEvent (mutable_state_builder.go:2199):
        write the deferred started event now that the activity is closing."""
        ai = ms.pending_activity_info_ids.get(schedule_id)
        if ai is None or ai.started_id != TRANSIENT_EVENT_ID:
            return None
        event = txn.add(EventType.ActivityTaskStarted,
                        scheduled_event_id=schedule_id,
                        attempt=ai.attempt, request_id=ai.request_id,
                        last_failure_reason=ai.last_failure_reason)
        if ai.started_time != 0:
            # started event keeps the real start time recorded in the info
            event.timestamp = ai.started_time
        return event

    def _respond_activity(self, token: TaskToken, close_type: EventType,
                          try_retry: bool = False, **extra: Any) -> None:
        """One activity response transaction. With `try_retry`, a failure
        with remaining retry budget re-attempts transiently (no events);
        only the final outcome reaches history."""
        ms, expected = self._load(token.domain_id, token.workflow_id, token.run_id)
        if ms.execution_info.state == WorkflowState.Completed:
            raise InvalidRequestError("workflow execution already completed")
        ai = ms.pending_activity_info_ids.get(token.schedule_id)
        # a token minted while the start was buffered carries the sentinel
        # and stays valid after the flush gave the start its real ID
        started_matches = ai is not None and (
            ai.started_id == token.started_id
            or (token.started_id == BUFFERED_EVENT_ID and ai.started_id > 0))
        if (ai is None or not started_matches
                or ai.attempt != token.attempt
                or self._buffered_close_exists(
                    ms, scheduled_event_id=token.schedule_id)):
            raise InvalidRequestError("activity task no longer current")
        if try_retry and retry_activity(ms, ai, self.clock.now(),
                                        extra.get("reason", "")):
            self._commit_transient(ms, expected)
            self._publish_sync_activity(ms, ai)
            return
        if self._has_inflight_decision(ms):
            # close buffers behind the running decision; a transient start
            # (retry-policy activity) buffers its deferred started event
            # first so the flush order start→close holds
            self._buffer_transient_started(ms, ai, token.schedule_id)
            self._buffer_event(ms, expected, close_type,
                               scheduled_event_id=token.schedule_id,
                               started_event_id=ai.started_id, **extra)
            return
        txn = self._new_transaction(ms)
        started_id = ai.started_id
        transient = self._flush_transient_started(txn, ms, token.schedule_id)
        if transient is not None:
            started_id = transient.id
        txn.add(close_type, scheduled_event_id=token.schedule_id,
                started_event_id=started_id, **extra)
        self._maybe_schedule_decision(txn, ms)
        txn.commit(expected)

    def respond_activity_task_completed(self, token: TaskToken,
                                        result: bytes = b"") -> None:
        self._respond_activity(token, EventType.ActivityTaskCompleted)

    def respond_activity_task_failed(self, token: TaskToken,
                                     reason: str = "") -> None:
        self._respond_activity(token, EventType.ActivityTaskFailed,
                               try_retry=True, reason=reason)

    def respond_activity_task_canceled(self, token: TaskToken) -> None:
        self._respond_activity(token, EventType.ActivityTaskCanceled)

    def _commit_transient(self, ms: MutableState,
                          expected_next_event_id: int) -> None:
        """Persist a mutable-state-only change (no history events): the
        transient activity start/retry transaction. Runs the timer sequence
        like every transaction close (CloseTransactionAsMutation).

        Replication: a sync-activity message (reference
        mutable_state_builder.go:3864 syncActivityTasks) streams the
        attempt/failure state to standbys; see _publish_sync_activity."""
        taskgen.generate_activity_timer_tasks(ms)
        taskgen.generate_user_timer_tasks(ms)
        info = ms.execution_info
        transfer, timer = list(ms.transfer_tasks), list(ms.timer_tasks)
        ms.transfer_tasks, ms.timer_tasks = [], []
        self.shard.insert_tasks(info.domain_id, info.workflow_id,
                                info.run_id, transfer, timer)
        self.shard.update_workflow(ms, expected_next_event_id)

    # ------------------------------------------------------------------
    # Signals / cancel / terminate (historyEngine.go:2202,:2629 region)
    # ------------------------------------------------------------------

    @tracing.traced(m.SCOPE_HISTORY_SIGNAL)
    def signal_workflow(self, domain_id: str, workflow_id: str,
                        signal_name: str, run_id: Optional[str] = None,
                        request_id: Optional[str] = None) -> None:
        """request_id dedups at-least-once signal legs (historyEngine.go
        SignalWorkflowExecution's IsSignalRequested/AddSignalRequested): a
        redelivered signal with an already-applied request id is a no-op
        instead of a duplicate WorkflowExecutionSignaled event."""
        self.metrics.inc(m.SCOPE_HISTORY_SIGNAL, m.M_REQUESTS)
        ms, expected = self._load(domain_id, workflow_id, run_id)
        self._require_running(ms)
        if request_id and request_id in ms.signal_requested_ids:
            return
        if request_id:
            ms.signal_requested_ids.add(request_id)
        # the request id rides the event itself so StateBuilder replay
        # (recovery, standby rebuild, NDC) repopulates the dedup set — a
        # cross-cluster redelivery AFTER a crash must still be a no-op
        attrs = dict(signal_name=signal_name)
        if request_id:
            attrs["request_id"] = request_id
        if self._has_inflight_decision(ms):
            # buffered until the in-flight decision closes; no new decision
            # scheduled (one is already running)
            self._buffer_event(ms, expected, EventType.WorkflowExecutionSignaled,
                               **attrs)
            return
        txn = self._new_transaction(ms)
        txn.add(EventType.WorkflowExecutionSignaled, **attrs)
        self._maybe_schedule_decision(txn, ms)
        txn.commit(expected)

    def signal_with_start_workflow(self, domain_id: str, workflow_id: str,
                                   signal_name: str, workflow_type: str,
                                   task_list: str,
                                   execution_timeout: int = 3600,
                                   decision_timeout: int = 10,
                                   cron_schedule: str = "",
                                   retry_policy=None,
                                   request_id: Optional[str] = None) -> str:
        """SignalWithStartWorkflowExecution: signal the current run, or
        atomically start a new run whose FIRST transaction already contains
        the signal (workflowHandler.go:2489-2496; historyEngine.go
        signalWithStartWorkflow). The signal-during-close race resolves by
        retrying: a run that closes between the read and the signal commit
        flips this call to the start arm; a start that loses the create
        race flips it back to the signal arm — the create fence and the
        next-event-id CAS make whichever arm wins atomic."""
        from .persistence import (
            ConditionFailedError,
            WorkflowAlreadyStartedError,
        )

        for _ in range(5):
            try:
                run_id = self.stores.execution.get_current_run_id(
                    domain_id, workflow_id)
                ms = self.stores.execution.get_workflow(domain_id,
                                                        workflow_id, run_id)
                if ms.execution_info.state != WorkflowState.Completed:
                    try:
                        # the request id dedups the SIGNAL arm too
                        # (SignalWithStartWorkflowExecutionRequest.
                        # RequestId): a client retry after a crash must
                        # not double-apply the signal
                        self.signal_workflow(domain_id, workflow_id,
                                             signal_name, run_id,
                                             request_id=request_id)
                        return run_id
                    except (EntityNotExistsError, ConditionFailedError):
                        # closed (or raced) between read and commit:
                        # retry as a start
                        continue
            except EntityNotExistsError:
                pass
            try:
                return self.start_workflow(
                    domain_id=domain_id, workflow_id=workflow_id,
                    workflow_type=workflow_type, task_list=task_list,
                    execution_timeout=execution_timeout,
                    decision_timeout=decision_timeout,
                    cron_schedule=cron_schedule, retry_policy=retry_policy,
                    request_id=request_id,
                    initial_signals=((signal_name, request_id),))
            except WorkflowAlreadyStartedError:
                continue  # lost the create race: retry as a signal
        raise InvalidRequestError(
            f"signal_with_start {workflow_id}: unresolved start/close race")

    def request_cancel_workflow(self, domain_id: str, workflow_id: str,
                                run_id: Optional[str] = None,
                                cause: str = "") -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        self._require_running(ms)
        if ms.execution_info.cancel_requested or any(
                e.event_type == EventType.WorkflowExecutionCancelRequested
                for e in ms.buffered_events):
            raise InvalidRequestError("cancellation already requested")
        if self._has_inflight_decision(ms):
            self._buffer_event(ms, expected,
                               EventType.WorkflowExecutionCancelRequested,
                               cause=cause)
            return
        txn = self._new_transaction(ms)
        txn.add(EventType.WorkflowExecutionCancelRequested, cause=cause)
        self._maybe_schedule_decision(txn, ms)
        txn.commit(expected)

    def terminate_workflow(self, domain_id: str, workflow_id: str,
                           run_id: Optional[str] = None,
                           reason: str = "") -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        self._require_running(ms)
        # a force-close discards the buffer (the reference drops buffered
        # events when the workflow closes without a decision to flush them)
        ms.buffered_events = []
        txn = self._new_transaction(ms)
        txn.add(EventType.WorkflowExecutionTerminated, reason=reason)
        txn.commit(expected)
        self.queries.fail_all(
            (domain_id, workflow_id, ms.execution_info.run_id),
            "workflow execution terminated")

    def reset_workflow(self, domain_id: str, workflow_id: str,
                       run_id: Optional[str] = None, *,
                       decision_finish_event_id: int,
                       reason: str = "") -> str:
        """ResetWorkflowExecution (historyEngine.go:2629 →
        reset/resetter.go:96 replayResetWorkflow).

        The base run's history is forked right before
        `decision_finish_event_id` (the close of the decision being reset,
        so the prefix ends with that decision in flight), the prefix is
        rebuilt ON DEVICE into the new run's mutable state
        (engine/rebuild.py — the stateRebuilder seat the reference fills
        with a per-workflow Go replay), the in-flight decision is failed
        with a reset cause, signals recorded after the reset point are
        re-applied (ndc/events_reapplier.go), and the new run becomes
        current; a still-running base run is terminated first."""
        self.metrics.inc(m.SCOPE_HISTORY_RESET, m.M_REQUESTS)
        base_ms, _ = self._load(domain_id, workflow_id, run_id)
        base_info = base_ms.execution_info
        run_id = base_info.run_id
        events = self.stores.history.read_events(domain_id, workflow_id, run_id)
        prev = next((e for e in events
                     if e.id == decision_finish_event_id - 1), None)
        if prev is None or prev.event_type != EventType.DecisionTaskStarted:
            # the reset point must be a decision boundary (resetter.go
            # validateResetWorkflowBeforeReplay): the event before the
            # finish ID is the decision's started event
            raise InvalidRequestError(
                "reset point must be the close of a decision: event "
                f"{decision_finish_event_id - 1} is not a decision start")

        new_run_id = str(uuid.uuid4())
        prefix: List[HistoryBatch] = []
        for b in self.stores.history.read_batches(domain_id, workflow_id,
                                                  run_id):
            keep = [e for e in b if e.id < decision_finish_event_id]
            if keep:
                prefix.append(HistoryBatch(
                    domain_id=domain_id, workflow_id=workflow_id,
                    run_id=new_run_id, events=keep))
            if len(keep) < len(b):
                break

        # device-first rebuild of the forked prefix (oracle fallback counted)
        from .rebuild import DeviceRebuilder
        if not hasattr(self, "rebuilder"):
            self.rebuilder = DeviceRebuilder(self.config.payload_layout(),
                                             device=self.device)
        new_ms = self.rebuilder.rebuild_one(prefix, self._domain_entry(domain_id))
        new_ms.domain_entry = self._domain_entry(domain_id)

        # terminate the base run while it still owns the current pointer
        # (resetter terminateWorkflow; no-op when it already closed)
        if base_info.state != WorkflowState.Completed:
            self.terminate_workflow(domain_id, workflow_id, run_id,
                                    reason=f"reset: {reason}")

        # new-run events: fail the in-flight decision, re-apply post-reset
        # signals, all in one batch continuing the forked event ids
        txn = self._new_transaction(new_ms)
        txn.add(EventType.DecisionTaskFailed,
                scheduled_event_id=new_ms.execution_info.decision_schedule_id,
                started_event_id=new_ms.execution_info.decision_started_id,
                cause="reset-workflow", reason=reason)
        for e in events:
            if (e.id >= decision_finish_event_id
                    and e.event_type == EventType.WorkflowExecutionSignaled):
                txn.add(EventType.WorkflowExecutionSignaled, **dict(e.attrs))
        batch = HistoryBatch(domain_id=domain_id, workflow_id=workflow_id,
                             run_id=new_run_id, events=txn.events)
        StateBuilder(new_ms).apply_batch(batch)
        # the rebuilt state carries NO tasks (rebuilders discard them), so
        # regenerate every dispatchable task — pending activities and
        # timers forked into the prefix, the workflow-timeout timer, the
        # transient decision — exactly the state-rebuild case the task
        # refresher exists for (mutable_state_task_refresher.go:77)
        new_ms.transfer_tasks, new_ms.timer_tasks = [], []
        new_ms.cross_cluster_tasks = []
        events_by_id = {e.id: e for pb in prefix for e in pb.events}
        events_by_id.update({e.id: e for e in txn.events})
        _refresh(new_ms, events_by_id)
        transfer = list(new_ms.transfer_tasks)
        timer = list(new_ms.timer_tasks)
        new_ms.transfer_tasks, new_ms.timer_tasks = [], []

        # history first, execution row as the commit point (see
        # start_workflow's ordering note)
        for pb in prefix:
            self.shard.append_history(domain_id, workflow_id, new_run_id,
                                      pb.events)
        self.shard.append_history(domain_id, workflow_id, new_run_id,
                                  txn.events)
        self.shard.insert_tasks(domain_id, workflow_id, new_run_id,
                                transfer, timer)
        self.shard.create_workflow(new_ms)  # commit point
        self._publish_replication(domain_id, workflow_id, new_run_id,
                                  txn.events, new_ms)
        self.notifier.notify((domain_id, workflow_id, new_run_id),
                             new_ms.execution_info.next_event_id, False)
        return new_run_id

    # ------------------------------------------------------------------
    # Timer-queue callbacks (timer_active_task_executor.go analogs)
    # ------------------------------------------------------------------

    def fire_user_timer(self, domain_id: str, workflow_id: str, run_id: str,
                        started_event_id: int) -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        if ms.execution_info.state == WorkflowState.Completed:
            return
        timer_id = ms.pending_timer_event_id_to_id.get(started_event_id)
        if timer_id is None:
            return  # already fired/canceled
        if self._buffered_close_exists(ms, timer_id=timer_id):
            return  # fired while buffered; pending until flush
        if self._has_inflight_decision(ms):
            self._buffer_event(ms, expected, EventType.TimerFired,
                               timer_id=timer_id,
                               started_event_id=started_event_id)
            return
        txn = self._new_transaction(ms)
        txn.add(EventType.TimerFired, timer_id=timer_id,
                started_event_id=started_event_id)
        self._maybe_schedule_decision(txn, ms)
        txn.commit(expected)

    def activity_timeout(self, domain_id: str, workflow_id: str, run_id: str,
                         schedule_id: int, timeout_type: int,
                         attempt: int = 0) -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        if ms.execution_info.state == WorkflowState.Completed:
            return
        ai = ms.pending_activity_info_ids.get(schedule_id)
        if ai is None:
            return
        if ai.attempt != attempt:
            return  # timer from a superseded attempt is stale
        tt = TimeoutType(timeout_type)
        started = ai.started_id != EMPTY_EVENT_ID
        # validity per timer type (timer_active_task_executor.go)
        if tt in (TimeoutType.StartToClose, TimeoutType.Heartbeat) and not started:
            return
        if tt == TimeoutType.ScheduleToStart and started:
            return  # schedule-to-start no longer applicable once started
        # started-activity timeouts retry before closing (the timer
        # executor's RetryActivity call); schedule-to-{start,close} are the
        # dispatch/overall deadlines and close directly
        if tt in (TimeoutType.StartToClose, TimeoutType.Heartbeat):
            if retry_activity(ms, ai, self.clock.now(), f"cadenceInternal:Timeout {tt.name}"):
                self._commit_transient(ms, expected)
                self._publish_sync_activity(ms, ai)
                return
        if self._buffered_close_exists(ms, scheduled_event_id=schedule_id):
            return
        if self._has_inflight_decision(ms):
            self._buffer_transient_started(ms, ai, schedule_id)
            self._buffer_event(ms, expected, EventType.ActivityTaskTimedOut,
                               scheduled_event_id=schedule_id,
                               started_event_id=ai.started_id,
                               timeout_type=int(tt))
            return
        txn = self._new_transaction(ms)
        started_id = ai.started_id
        transient = self._flush_transient_started(txn, ms, schedule_id)
        if transient is not None:
            started_id = transient.id
        txn.add(EventType.ActivityTaskTimedOut, scheduled_event_id=schedule_id,
                started_event_id=started_id, timeout_type=int(tt))
        self._maybe_schedule_decision(txn, ms)
        txn.commit(expected)

    def decision_timeout(self, domain_id: str, workflow_id: str, run_id: str,
                         schedule_id: int, timeout_type: int) -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        info = ms.execution_info
        if info.state == WorkflowState.Completed:
            return
        if info.decision_schedule_id != schedule_id:
            return  # decision already completed
        tt = TimeoutType(timeout_type)
        txn = self._new_transaction(ms)
        if tt == TimeoutType.ScheduleToStart:
            # the sticky dispatch deadline (timer_active_task_executor
            # handleDecisionTimeout SCHEDULE_TO_START arm): only meaningful
            # while the decision is still unstarted; the attempt does NOT
            # increment (no transient), stickiness clears, and an explicit
            # scheduled event re-dispatches on the NORMAL task list
            if info.decision_started_id != EMPTY_EVENT_ID:
                return  # started in the meantime: deadline no longer applies
            txn.add(EventType.DecisionTaskTimedOut,
                    scheduled_event_id=schedule_id,
                    started_event_id=EMPTY_EVENT_ID,
                    timeout_type=int(tt))
            txn.add(EventType.DecisionTaskScheduled, task_list=info.task_list,
                    start_to_close_timeout_seconds=info.decision_start_to_close_timeout,
                    attempt=0)
            txn.commit(expected)
            return
        txn.add(EventType.DecisionTaskTimedOut, scheduled_event_id=schedule_id,
                started_event_id=info.decision_started_id,
                timeout_type=timeout_type)
        # the timed-out decision's buffer flushes behind the close event;
        # like the failed path, flushed events force a REAL follow-up
        # decision instead of a transient (:373-382)
        self._flush_and_reschedule(txn, ms)
        txn.commit(expected)
        self.queries.requeue_started((domain_id, workflow_id, run_id))

    def timeout_workflow(self, domain_id: str, workflow_id: str, run_id: str) -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        if ms.execution_info.state == WorkflowState.Completed:
            return
        ms.buffered_events = []  # force-close discards the buffer
        txn = self._new_transaction(ms)
        txn.add(EventType.WorkflowExecutionTimedOut)
        txn.commit(expected)
        self.queries.fail_all((domain_id, workflow_id, run_id),
                              "workflow execution timed out")

    def schedule_first_decision(self, domain_id: str, workflow_id: str,
                                run_id: str) -> None:
        """WorkflowBackoffTimer fired (cron/retry start backoff elapsed)."""
        ms, expected = self._load(domain_id, workflow_id, run_id)
        info = ms.execution_info
        if info.state == WorkflowState.Completed:
            return
        if info.decision_schedule_id != EMPTY_EVENT_ID:
            return
        txn = self._new_transaction(ms)
        txn.add(EventType.DecisionTaskScheduled, task_list=info.task_list,
                start_to_close_timeout_seconds=info.decision_start_to_close_timeout,
                attempt=0)
        txn.commit(expected)

    # ------------------------------------------------------------------
    # Cross-workflow deliveries (transfer-queue executors call these)
    # ------------------------------------------------------------------

    def on_child_started(self, domain_id: str, workflow_id: str, run_id: str,
                         initiated_id: int, child_run_id: str) -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        ci = ms.pending_child_execution_info_ids.get(initiated_id)
        if ci is None or ci.started_id != EMPTY_EVENT_ID:
            return  # unknown or already started (redelivered transfer task)
        if self._has_inflight_decision(ms):
            # record the start in state now (the buffered sentinel keeps
            # the close linkage patchable at flush, like activity starts)
            ci.started_id = BUFFERED_EVENT_ID
            ci.started_run_id = child_run_id
            self._buffer_event(ms, expected,
                               EventType.ChildWorkflowExecutionStarted,
                               initiated_event_id=initiated_id,
                               run_id=child_run_id)
            return
        txn = self._new_transaction(ms)
        txn.add(EventType.ChildWorkflowExecutionStarted,
                initiated_event_id=initiated_id, run_id=child_run_id)
        txn.commit(expected)

    def on_child_start_failed(self, domain_id: str, workflow_id: str,
                              run_id: str, initiated_id: int,
                              cause: str = "WORKFLOW_ALREADY_RUNNING") -> None:
        """StartChildWorkflowExecutionFailed on the parent (the start
        could not be honored — target already running; the cross-cluster
        and local start paths share this response arm)."""
        ms, expected = self._load(domain_id, workflow_id, run_id)
        ci = ms.pending_child_execution_info_ids.get(initiated_id)
        if ci is None or ci.started_id != EMPTY_EVENT_ID:
            return
        if self._has_inflight_decision(ms):
            # at-least-once delivery: a redelivered failure must not
            # buffer a second Failed event (the double delete would break
            # replay) — mirror on_child_closed's buffered dedup
            if any(e.event_type == EventType.StartChildWorkflowExecutionFailed
                   and e.get("initiated_event_id") == initiated_id
                   for e in ms.buffered_events):
                return
            self._buffer_event(ms, expected,
                               EventType.StartChildWorkflowExecutionFailed,
                               initiated_event_id=initiated_id, cause=cause)
            return
        txn = self._new_transaction(ms)
        txn.add(EventType.StartChildWorkflowExecutionFailed,
                initiated_event_id=initiated_id, cause=cause)
        self._maybe_schedule_decision(txn, ms)
        txn.commit(expected)

    def on_child_closed(self, domain_id: str, workflow_id: str, run_id: str,
                        initiated_id: int, close_event_type: EventType) -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        ci = ms.pending_child_execution_info_ids.get(initiated_id)
        if ci is None or ms.execution_info.state == WorkflowState.Completed:
            return
        if self._buffered_close_exists(ms, initiated_event_id=initiated_id):
            return
        if self._has_inflight_decision(ms):
            self._buffer_event(ms, expected, close_event_type,
                               initiated_event_id=initiated_id,
                               started_event_id=ci.started_id)
            return
        txn = self._new_transaction(ms)
        txn.add(close_event_type, initiated_event_id=initiated_id,
                started_event_id=ci.started_id)
        self._maybe_schedule_decision(txn, ms)
        txn.commit(expected)

    def on_external_signaled(self, domain_id: str, workflow_id: str,
                             run_id: str, initiated_id: int,
                             failed: bool = False) -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        if initiated_id not in ms.pending_signal_info_ids:
            return
        et = (EventType.SignalExternalWorkflowExecutionFailed if failed
              else EventType.ExternalWorkflowExecutionSignaled)
        if self._has_inflight_decision(ms):
            if not any(e.get("initiated_event_id") == initiated_id
                       for e in ms.buffered_events):
                self._buffer_event(ms, expected, et,
                                   initiated_event_id=initiated_id)
            return
        txn = self._new_transaction(ms)
        txn.add(et, initiated_event_id=initiated_id)
        self._maybe_schedule_decision(txn, ms)
        txn.commit(expected)

    def on_external_cancel_delivered(self, domain_id: str, workflow_id: str,
                                     run_id: str, initiated_id: int,
                                     failed: bool = False) -> None:
        ms, expected = self._load(domain_id, workflow_id, run_id)
        if initiated_id not in ms.pending_request_cancel_info_ids:
            return
        et = (EventType.RequestCancelExternalWorkflowExecutionFailed if failed
              else EventType.ExternalWorkflowExecutionCancelRequested)
        if self._has_inflight_decision(ms):
            if not any(e.get("initiated_event_id") == initiated_id
                       for e in ms.buffered_events):
                self._buffer_event(ms, expected, et,
                                   initiated_event_id=initiated_id)
            return
        txn = self._new_transaction(ms)
        txn.add(et, initiated_event_id=initiated_id)
        self._maybe_schedule_decision(txn, ms)
        txn.commit(expected)

    # ------------------------------------------------------------------
    # Retention deletion (timer DeleteHistoryEvent →
    # timerQueueProcessor deleteWorkflow; backstop: the history scavenger,
    # service/worker/scanner — engine/workers.py)
    # ------------------------------------------------------------------

    def delete_workflow_execution(self, domain_id: str, workflow_id: str,
                                  run_id: str) -> bool:
        """Delete a CLOSED run's history, snapshot, visibility record, and
        in-memory registrations once its retention elapsed. Never touches
        an open run. Returns True when anything was deleted."""
        try:
            ms = self.stores.execution.get_workflow(domain_id, workflow_id,
                                                    run_id)
        except EntityNotExistsError:
            ms = None
        if ms is not None and ms.execution_info.state != WorkflowState.Completed:
            return False  # open run: retention never deletes live state
        key = (domain_id, workflow_id, run_id)
        deleted = self.stores.history.delete_run(*key)
        deleted = self.stores.execution.delete_workflow(*key) or deleted
        self.stores.visibility.delete_record(*key)
        self.notifier.forget(key)
        self.queries.drop_key(key)
        if deleted:
            self.metrics.inc(m.SCOPE_WORKER_RETENTION, m.M_RUNS_DELETED)
        return deleted

    # ------------------------------------------------------------------
    # Task refresh (mutable_state_task_refresher.go:77 RefreshTasks)
    # ------------------------------------------------------------------

    def refresh_tasks(self, domain_id: str, workflow_id: str,
                      run_id: Optional[str] = None) -> int:
        """Regenerate all outstanding tasks from mutable state and insert
        them into this shard's queues. Called on standby promotion (the
        workflow changed hands and its task rows live on the old active
        cluster) and by admin refresh. Returns the number of tasks created."""
        ms, expected = self._load(domain_id, workflow_id, run_id)
        run_id = ms.execution_info.run_id
        events = self.stores.history.read_events(domain_id, workflow_id, run_id)
        ms.transfer_tasks, ms.timer_tasks = [], []
        _refresh(ms, {e.id: e for e in events})
        transfer, timer = list(ms.transfer_tasks), list(ms.timer_tasks)
        ms.transfer_tasks, ms.timer_tasks = [], []
        # persist the refreshed timer-created bits so later transactions
        # don't double-create activity/user timer tasks
        self.shard.update_workflow(ms, expected)
        self.shard.insert_tasks(domain_id, workflow_id, run_id, transfer, timer)
        return len(transfer) + len(timer)

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def _enforce_history_limits(self, ms: MutableState) -> None:
        """History growth enforcement (the size_limit contract): past the
        warn threshold the breach is logged+counted; past the error
        threshold the run is TERMINATED — unbounded growth is how one
        workflow takes down a shard (host/size_limit_test.go; the
        reference enforces in workflowExecutionContext's transaction)."""
        from .limits import TERMINATE_REASON, history_limits

        info = ms.execution_info
        if info.state == WorkflowState.Completed:
            return
        count_warn, count_error, size_warn, size_error = history_limits(
            self.config, ms.domain_entry.name)
        count = info.next_event_id - 1
        size = ms.history_size
        if (count_error and count > count_error) or (
                size_error and size > size_error):
            self.metrics.inc("limits", "history-limit-terminations")
            self.log.error("terminating run past history limit",
                           workflow_id=info.workflow_id, events=count,
                           history_size=size)
            try:
                self.terminate_workflow(info.domain_id, info.workflow_id,
                                        info.run_id, reason=TERMINATE_REASON)
            except (EntityNotExistsError, InvalidRequestError):
                pass  # closed in the race; the limit's goal is met
        elif (count_warn and count > count_warn) or (
                size_warn and size > size_warn):
            self.metrics.inc("limits", "history-limit-warnings")
            self.log.warning("history above warn threshold",
                             workflow_id=info.workflow_id, events=count,
                             history_size=size)

    def get_mutable_state(self, domain_id: str, workflow_id: str,
                          run_id: Optional[str] = None) -> MutableState:
        ms, _ = self._load(domain_id, workflow_id, run_id)
        return ms

    def query_result_tuple(self, domain_id: str, workflow_id: str,
                           run_id: str, query_id: str):
        """(state, result, failure) of a registered query — the
        wire-safe projection of the registry's PendingQuery (whose
        threading.Event must never be pickled across hosts)."""
        q = self.queries.get((domain_id, workflow_id, run_id), query_id)
        if q is None:
            raise KeyError(f"unknown query {query_id}")
        return q.state, q.result, q.failure

    def get_history(self, domain_id: str, workflow_id: str,
                    run_id: Optional[str] = None) -> List[HistoryEvent]:
        if run_id is None:
            run_id = self.stores.execution.get_current_run_id(domain_id, workflow_id)
        return self.stores.history.read_events(domain_id, workflow_id, run_id)

    def checksum(self, domain_id: str, workflow_id: str,
                 run_id: Optional[str] = None) -> Checksum:
        return Checksum.of(self.get_mutable_state(domain_id, workflow_id, run_id))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    @staticmethod
    def _require_running(ms: MutableState) -> None:
        if ms.execution_info.state == WorkflowState.Completed:
            raise EntityNotExistsError("workflow execution already completed")

    @staticmethod
    def _maybe_schedule_decision(txn: "_Txn", ms: MutableState) -> None:
        """Schedule a decision when none is pending (the signal/timer/activity
        completion paths all do this, e.g. historyEngine signal path). A
        sticky task list pins dispatch to the worker that completed the last
        decision (mutable_state_decision_task_manager.go:384-390)."""
        info = ms.execution_info
        if info.decision_schedule_id == EMPTY_EVENT_ID:
            txn.add(EventType.DecisionTaskScheduled,
                    task_list=info.sticky_task_list or info.task_list,
                    start_to_close_timeout_seconds=info.decision_start_to_close_timeout,
                    attempt=0)


class _Txn:
    """One workflow transaction: builds the event batch, applies it through
    the oracle StateBuilder, persists atomically (context.go:105 analog)."""

    def __init__(self, engine: HistoryEngine, ms: MutableState) -> None:
        self.engine = engine
        self.ms = ms
        self.events: List[HistoryEvent] = []
        self._next_id = ms.execution_info.next_event_id
        self._post: List = []
        #: IDs introduced earlier in this batch (pre-commit dedup)
        self.added_activity_ids: set = set()
        self.added_timer_ids: set = set()
        #: set by _flush_and_reschedule: drop decision dispatch tasks for
        #: any schedule ID other than the final one (the replay of the
        #: fail/timeout close event momentarily creates a transient whose
        #: provisional ID a flushed event then takes)
        self.drop_stale_decision_tasks = False

    def add(self, event_type: EventType, **attrs: Any) -> HistoryEvent:
        ev = HistoryEvent(
            id=self._next_id, event_type=event_type,
            version=self.ms.domain_entry.failover_version,
            timestamp=self.engine.clock.now(),
            attrs=attrs,
        )
        self._next_id += 1
        self.events.append(ev)
        return ev

    def add_flushed(self, buffered: HistoryEvent,
                    attrs: Dict[str, Any]) -> HistoryEvent:
        """Assign a real ID to a buffered event, preserving its original
        version and timestamp (FlushBufferedEvents reassigns IDs only)."""
        ev = HistoryEvent(
            id=self._next_id, event_type=buffered.event_type,
            version=buffered.version, timestamp=buffered.timestamp,
            attrs=attrs,
        )
        self._next_id += 1
        self.events.append(ev)
        return ev

    def after_commit(self, fn) -> None:
        self._post.append(fn)

    def commit(self, expected_next_event_id: int) -> None:
        if not self.events:
            return
        info = self.ms.execution_info
        # version arbitration, pre-apply: a split-brain peer's promotion
        # may have landed on this workflow through replication (its
        # current branch now ends at a HIGHER failover version) before
        # this cluster's domain record caught up — this write would lose
        # NDC arbitration anyway, so reject it typed and untouched
        # instead of letting the version-history guard blow up mid-apply
        vh = self.ms.version_histories.current()
        if vh.items and vh.last_item().version > self.events[0].version:
            from .domain import DomainNotActiveError
            raise DomainNotActiveError(
                self.ms.domain_entry.name,
                f"the failover-version-{vh.last_item().version} cluster",
                f"a failover-version-{self.events[0].version} writer")
        batch = HistoryBatch(domain_id=info.domain_id,
                             workflow_id=info.workflow_id,
                             run_id=info.run_id, events=self.events)
        # active transactions keep sticky execution state; only the true
        # replay paths clear it (state_builder.go:108)
        StateBuilder(self.ms, clear_sticky=False).apply_batch(batch)
        # history-size accounting (mutableState GetHistorySize): the
        # codec-serialized batch is what the store pays for this commit;
        # the SAME bytes become the WAL record's blob below — one
        # serialize_history per transaction, not two
        events_blob = serialize_history([batch])
        self.ms.history_size += len(events_blob)
        new_transfer = list(self.ms.transfer_tasks)
        new_timer = list(self.ms.timer_tasks)
        if self.drop_stale_decision_tasks:
            from ..core.enums import TransferTaskType
            final_sched = self.ms.execution_info.decision_schedule_id
            new_transfer = [
                t for t in new_transfer
                if not (t.task_type == TransferTaskType.DecisionTask
                        and t.event_id != final_sched)]
        # tasks are drained into the shard queues at commit; the persisted
        # snapshot must not accumulate them across transactions
        self.ms.transfer_tasks, self.ms.timer_tasks = [], []
        # reference write order (context.go): events first, then tasks,
        # then the fenced conditional state update as the COMMIT POINT
        # (shard/context.go:586-700 range-ID fence). A failure before the
        # update leaves only harmless garbage: an orphan history tail that
        # the next append OVERWRITES (append_batch's node-overwrite
        # semantics) and stale tasks the executors' guards drop. The shard
        # holds its lock across the compound op and prechecks the state
        # CAS, so a concurrent writer of the same workflow fails before
        # it can clobber this transaction's committed tail.
        try:
            version = self.engine.shard.commit_workflow(
                self.ms, expected_next_event_id, self.events,
                new_transfer, new_timer, events_blob=events_blob)
        except Exception:
            # the entry that fed this transaction may be stale (a foreign
            # writer won) — drop it so the caller's retry reads fresh
            self.engine.execution_cache.invalidate(
                info.domain_id, info.workflow_id, info.run_id)
            raise
        self.engine.execution_cache.store(
            info.domain_id, info.workflow_id, info.run_id, self.ms,
            version if version is not None else 0)
        self.engine.log.debug(
            "transaction committed", domain_id=info.domain_id,
            workflow_id=info.workflow_id, run_id=info.run_id,
            first_event_id=self.events[0].id,
            next_event_id=info.next_event_id,
            transfer_tasks=len(new_transfer), timer_tasks=len(new_timer))
        self.engine._publish_replication(info.domain_id, info.workflow_id,
                                         info.run_id, self.events, self.ms)
        # wake history long-polls (events/notifier.go NotifyNewHistoryEvent)
        from ..core.enums import WorkflowState as _WS
        self.engine.notifier.notify(
            (info.domain_id, info.workflow_id, info.run_id),
            info.next_event_id, info.state == _WS.Completed)
        # COMMITTED batch → device-serving tier: the
        # oracle applied and persisted above; the scheduler maintains the
        # HBM-resident twin and gates per-transaction parity
        self.engine._hand_to_serving(self.ms, events_blob, batch)
        flightrecorder.emit(
            "txn-commit", domain_id=info.domain_id,
            workflow_id=info.workflow_id, run_id=info.run_id,
            shard_id=self.engine.shard.shard_id,
            first_event_id=self.events[0].id,
            next_event_id=info.next_event_id,
            events=len(self.events), transfer_tasks=len(new_transfer),
            timer_tasks=len(new_timer))
        for fn in self._post:
            fn()
        self.engine._enforce_history_limits(self.ms)
