"""Transfer and timer queue processors: the background engine heartbeat.

Reference: service/history/queue/ (transfer_queue_processor.go:88,
timer_queue_processor.go:75) + the per-task executors in
service/history/task/ (transfer_active_task_executor.go:108-287 routes
decision/activity tasks to matching and handles close-execution fan-out;
timer_active_task_executor.go fires user timers, activity/decision
timeouts, workflow timeout and backoff timers).

Single-threaded pump with explicit ack levels — the reference's worker
pools and multi-level processing queues parallelize the same loop.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional

from ..core.enums import (
    EMPTY_EVENT_ID,
    CloseStatus,
    EventType,
    TimerTaskType,
    TransferTaskType,
)
from ..oracle.mutable_state import GeneratedTask
from ..utils import metrics as m
from ..utils.clock import TimeSource
from ..utils.metrics import SCOPE_QUEUE_TIMER, SCOPE_QUEUE_TRANSFER
from .history_engine import InvalidRequestError
from .matching import MatchingEngine
from .persistence import (
    EntityNotExistsError,
    Stores,
    WorkflowAlreadyStartedError,
)

if TYPE_CHECKING:
    from .controller import ShardController
    from .history_engine import HistoryEngine

#: child close status → parent-facing event type
#: (transfer_active_task_executor.go processCloseExecution → parent
#: RecordChildExecutionCompleted delivery)
_CHILD_CLOSE_EVENT = {
    CloseStatus.Completed: EventType.ChildWorkflowExecutionCompleted,
    CloseStatus.Failed: EventType.ChildWorkflowExecutionFailed,
    CloseStatus.Canceled: EventType.ChildWorkflowExecutionCanceled,
    CloseStatus.Terminated: EventType.ChildWorkflowExecutionTerminated,
    CloseStatus.TimedOut: EventType.ChildWorkflowExecutionTimedOut,
}


class _ProcessingQueue:
    """One level of a shard's transfer queue (queue/interface.go
    ProcessingQueueState): its own ack manager and a domain filter —
    either an allowlist (a split-off hot domain) or the base queue's
    exclusion set. Reads, submissions, and ack advancement are all
    per-queue, so a hot domain's backlog holds back only ITS level."""

    def __init__(self, level: int, ack_level: int, domains=None,
                 excluded=()) -> None:
        from .tasks import AckManager
        self.level = level
        self.ack = AckManager(ack_level)
        self.domains = frozenset(domains) if domains is not None else None
        self.excluded = set(excluded)
        self.drained = False
        #: read cursor (the reference's read level): sweeps read FORWARD
        #: from here so in-flight stragglers near the ack never clog the
        #: window; resets to the persisted ack on restore, where the
        #: register dedup absorbs the re-read
        self.read_level = ack_level
        #: in-flight task id → domain (split takes over a domain's
        #: in-flight tasks from the base when it forms)
        self.domain_of: dict = {}

    def accepts(self, domain_id: str) -> bool:
        if self.domains is not None:
            return domain_id in self.domains
        return domain_id not in self.excluded

    def state(self) -> list:
        return [self.level, self.ack.ack_level(),
                sorted(self.domains) if self.domains is not None else None,
                sorted(self.excluded)]


class _ShardTransferQueues:
    """A shard's processing-queue collection + split/merge policy
    (queue/split_policy.go, transfer_queue_processor.go)."""

    def __init__(self, persisted: list, base_ack: int) -> None:
        if persisted:
            self.queues = [_ProcessingQueue(lvl, ack, dom, exc)
                           for lvl, ack, dom, exc in persisted]
        else:
            self.queues = [_ProcessingQueue(0, base_ack)]
        #: per-domain tasks observed pending in the latest sweep
        self.pending: dict = {}

    @property
    def base(self) -> _ProcessingQueue:
        return self.queues[0]

    def split(self, domain_id: str, max_level: int) -> bool:
        """Move a hot domain onto its own level: a new queue starting at
        the BASE ack (its unprocessed tasks are at or above it), the base
        excluding the domain so its own ack can advance past the hot
        backlog. The base RELEASES its in-flight tasks of that domain —
        the split re-reads and owns them from here (at-least-once
        executors make the duplicate window safe, the same window a
        crash-redelivery opens)."""
        if len(self.queues) >= max_level + 1:
            return False
        if any(q.domains and domain_id in q.domains for q in self.queues):
            return False
        split_ack = self.base.ack.ack_level()
        self.base.excluded.add(domain_id)
        for tid, dom in list(self.base.domain_of.items()):
            if dom == domain_id:
                self.base.ack.complete(tid)
                self.base.domain_of.pop(tid, None)
        self.queues.append(_ProcessingQueue(
            len(self.queues), split_ack, {domain_id}))
        return True

    def merge_drained(self) -> int:
        """Fold split queues back once safe: the split is DRAINED (no
        reads pending, nothing in flight) and the base ack has caught up
        past it — un-excluding earlier would re-deliver the range the
        split already consumed."""
        merged = 0
        keep = [self.base]
        for q in self.queues[1:]:
            if (q.drained and q.ack.in_flight() == 0
                    and self.base.ack.ack_level() >= q.ack.ack_level()):
                self.base.excluded -= set(q.domains or ())
                merged += 1
            else:
                keep.append(q)
        if merged:
            self.queues = keep
            for i, q in enumerate(self.queues):
                q.level = i
        return merged

    def min_ack(self) -> int:
        return min(q.ack.ack_level() for q in self.queues)

    def states(self) -> list:
        return [q.state() for q in self.queues]


class QueueProcessors:
    """Drains one controller's owned shards (active cluster side)."""

    def __init__(self, controller: "ShardController", matching: MatchingEngine,
                 stores: Stores, time_source: TimeSource,
                 router=None, metrics=None, config=None,
                 cluster_name: str = "primary") -> None:
        from ..utils.dynamicconfig import DynamicConfig
        from ..utils.metrics import DEFAULT_REGISTRY
        self.metrics = metrics if metrics is not None else DEFAULT_REGISTRY
        self.config = config if config is not None else DynamicConfig()
        self.controller = controller
        self.matching = matching
        self.stores = stores
        self.clock = time_source
        self.cluster_name = cluster_name
        #: set by multi-cluster wiring (engine/crosscluster.py): tasks
        #: targeting a domain active ELSEWHERE park for that cluster's
        #: processor instead of executing locally at the wrong version
        self.cross_cluster_publisher = None
        #: cluster-wide workflow→engine router for cross-workflow calls
        #: (the client/history peer-resolver analog); defaults to the local
        #: controller, which suffices for single-host clusters
        self.router = router or controller.engine_for_workflow

    def _dropped_not_exists(self, queue_scope: str) -> None:
        """An executor swallowed EntityNotExistsError (target workflow
        gone) — counted so the drops are visible, never swallowed
        invisibly."""
        self.metrics.inc(queue_scope, m.M_TASKS_DROPPED_NOT_EXISTS)

    # ------------------------------------------------------------------
    # transfer queue
    # ------------------------------------------------------------------

    def process_transfer_concurrent(self, scheduler) -> int:
        """N-worker MULTI-LEVEL transfer processing (parallelTaskProcessor
        + weightedRoundRobin + redispatcher + the processing-queue
        collection of queue/transfer_queue_processor.go): each shard runs
        a set of processing queues — level 0 for everyone, plus split-off
        levels for hot domains — each with its own reads, its own ack
        manager, and a persisted ack level. A domain whose observed
        backlog exceeds the split threshold moves to its own level, so
        its flood holds back only ITS ack while siblings' tasks keep
        flowing and acking; drained splits merge back once the base ack
        catches up. Tasks submit to the pool keyed by DOMAIN (fairness),
        complete out of order, and each QUEUE's persisted level advances
        only past its contiguous completed prefix — a crash mid-pool
        never skips a straggler."""
        from ..utils.dynamicconfig import (
            KEY_QUEUE_BATCH_SIZE,
            KEY_QUEUE_MAX_LEVEL,
            KEY_QUEUE_SPLIT_THRESHOLD,
        )
        from .faults import TransientStoreError
        from .persistence import ConditionFailedError, ShardOwnershipLostError
        from .tasks import EnvironmentalTaskError, RetryableTaskError

        if not hasattr(self, "_transfer_queues"):
            self._transfer_queues = {}
        threshold = int(self.config.get(KEY_QUEUE_SPLIT_THRESHOLD))
        max_level = int(self.config.get(KEY_QUEUE_MAX_LEVEL))
        batch = int(self.config.get(KEY_QUEUE_BATCH_SIZE))
        submitted = 0
        for shard_id in self.controller.assigned_shards():
            engine = self.controller.engine_for_shard(shard_id)
            shard = engine.shard
            state = self._transfer_queues.get(shard_id)
            if state is None:
                state = self._transfer_queues[shard_id] = _ShardTransferQueues(
                    shard.transfer_queue_states, shard.transfer_ack_level)
            base_pending: dict = {}
            for q in state.queues:
                # the base window stretches to threshold+1 so a backlog
                # big enough to warrant a split is actually observable
                window = (max(batch, threshold + 1) if q.level == 0
                          else batch)
                read_from = max(q.ack.ack_level(), q.read_level)
                tasks = shard.read_transfer_tasks(read_from, window)
                accepted = 0
                for task_id, domain_id, workflow_id, run_id, task in tasks:
                    q.read_level = max(q.read_level, task_id)
                    if not q.accepts(domain_id):
                        if q.domains is None and q.ack.register(task_id):
                            # base queue skips split-off domains but its
                            # ack must advance past their rows
                            q.ack.complete(task_id)
                        continue
                    accepted += 1
                    if q.level == 0:
                        base_pending[domain_id] = (
                            base_pending.get(domain_id, 0) + 1)
                    if not q.ack.register(task_id):
                        continue  # already in flight from a previous sweep
                    q.domain_of[task_id] = domain_id

                    def job(e=engine, d=domain_id, w=workflow_id, r=run_id,
                            t=task):
                        try:
                            self._execute_transfer(e, d, w, r, t)
                        except ConnectionError as exc:
                            # a dead/partitioned peer is ENVIRONMENTAL:
                            # the task must outlive the membership TTL
                            # window, or a dispatch dead-lettered
                            # mid-steal is a lost decision nothing
                            # recovers
                            raise EnvironmentalTaskError(str(exc))
                        except (ShardOwnershipLostError, ConditionFailedError,
                                TransientStoreError) as exc:
                            raise RetryableTaskError(str(exc))

                    def done(tid=task_id, pq=q):
                        pq.ack.complete(tid)
                        pq.domain_of.pop(tid, None)

                    scheduler.submit(domain_id, job, on_done=done)
                    submitted += 1
                q.drained = accepted == 0
            # split policy: a domain dominating the base window past the
            # threshold gets its own level (split_policy.go pending-count
            # policy); merge drained splits the base has caught up past
            for domain_id, n in base_pending.items():
                if n > threshold and state.split(domain_id, max_level):
                    self.metrics.inc(m.SCOPE_QUEUE_TRANSFER, "queue-splits")
                    self.log_split(shard_id, domain_id, n)
            merged = state.merge_drained()
            if merged:
                self.metrics.inc(m.SCOPE_QUEUE_TRANSFER, "queue-merges",
                                 merged)
            state.pending = base_pending
            new_states = state.states()
            if new_states != getattr(state, "persisted", None):
                try:
                    shard.update_transfer_queue_states(new_states,
                                                       state.min_ack())
                    state.persisted = new_states
                except ShardOwnershipLostError:
                    self._transfer_queues.pop(shard_id, None)
                except (TransientStoreError, ConnectionError):
                    pass  # deferred: the next sweep re-persists
        self.metrics.inc(m.SCOPE_QUEUE_TRANSFER, m.M_TASKS_PROCESSED,
                         submitted)
        return submitted

    def log_split(self, shard_id: int, domain_id: str, pending: int) -> None:
        from ..utils.log import DEFAULT_LOGGER
        DEFAULT_LOGGER.info("processing queue split", component="queues",
                            shard=shard_id, domain=domain_id,
                            pending=pending)

    def transfer_queue_states(self, shard_id: int) -> list:
        """The admin/DescribeQueue surface: per-level (level, ack,
        domains, excluded) for one shard."""
        state = getattr(self, "_transfer_queues", {}).get(shard_id)
        return state.states() if state is not None else []

    def process_transfer_once(self) -> int:
        """One pass over all owned shards; returns tasks processed."""
        processed = 0
        for shard_id in self.controller.assigned_shards():
            engine = self.controller.engine_for_shard(shard_id)
            shard = engine.shard
            tasks = shard.read_transfer_tasks(shard.transfer_ack_level)
            max_seen = shard.transfer_ack_level
            for task_id, domain_id, workflow_id, run_id, task in tasks:
                self._execute_transfer(engine, domain_id, workflow_id, run_id, task)
                max_seen = max(max_seen, task_id)
                processed += 1
            if tasks:
                shard.update_transfer_ack_level(max_seen)
        self.metrics.inc(m.SCOPE_QUEUE_TRANSFER, m.M_TASKS_PROCESSED, processed)
        return processed

    def _execute_transfer(self, engine: "HistoryEngine", domain_id: str,
                          workflow_id: str, run_id: str,
                          task: GeneratedTask) -> None:
        from .domain import DomainNotActiveError
        try:
            self._execute_transfer_active(engine, domain_id, workflow_id,
                                          run_id, task)
        except DomainNotActiveError:
            # version arbitration rejected the mutation pre-apply: a peer
            # cluster's promotion already landed on this workflow, so the
            # task belongs to the winner (whose promotion sweep
            # regenerates it) — drop, like the reference's standby
            # executors drop active-only tasks
            self.metrics.inc(SCOPE_QUEUE_TRANSFER, m.M_TASKS_DROPPED_STALE)

    def _execute_transfer_active(self, engine: "HistoryEngine",
                                 domain_id: str, workflow_id: str,
                                 run_id: str, task: GeneratedTask) -> None:
        tt = TransferTaskType(task.task_type)
        if tt == TransferTaskType.DecisionTask:
            # processDecisionTask → matching.AddDecisionTask
            self.matching.add_decision_task(domain_id, task.task_list,
                                            workflow_id, run_id, task.event_id)
        elif tt == TransferTaskType.ActivityTask:
            self.matching.add_activity_task(domain_id, task.task_list,
                                            workflow_id, run_id, task.event_id)
        elif tt == TransferTaskType.RecordWorkflowStarted:
            self._record_started(domain_id, workflow_id, run_id)
        elif tt == TransferTaskType.CloseExecution:
            self._process_close(domain_id, workflow_id, run_id)
        elif tt == TransferTaskType.StartChildExecution:
            self._start_child(engine, domain_id, workflow_id, run_id, task)
        elif tt == TransferTaskType.SignalExecution:
            self._signal_external(engine, domain_id, workflow_id, run_id, task)
        elif tt == TransferTaskType.CancelExecution:
            self._cancel_external(engine, domain_id, workflow_id, run_id, task)
        elif tt == TransferTaskType.UpsertWorkflowSearchAttributes:
            # advanced-visibility re-index (worker/indexer analog): fold
            # the state's current attributes into the visibility record
            try:
                ms = self.stores.execution.get_workflow(domain_id,
                                                        workflow_id, run_id)
            except EntityNotExistsError:
                self._dropped_not_exists(SCOPE_QUEUE_TRANSFER)
                return
            self.stores.visibility.upsert_search_attributes(
                domain_id, workflow_id, run_id,
                dict(ms.execution_info.search_attributes))
        elif tt == TransferTaskType.RecordChildExecutionCompleted:
            pass  # folded into _process_close's parent notification
        # remaining types (reset, parent close policy fan-out) arrive with
        # their subsystems

    def _record_started(self, domain_id: str, workflow_id: str, run_id: str) -> None:
        from .persistence import VisibilityRecord
        try:
            ms = self.stores.execution.get_workflow(domain_id, workflow_id, run_id)
        except EntityNotExistsError:
            self._dropped_not_exists(SCOPE_QUEUE_TRANSFER)
            return
        self.stores.visibility.record_started(VisibilityRecord(
            domain_id=domain_id, workflow_id=workflow_id, run_id=run_id,
            workflow_type=ms.execution_info.workflow_type_name,
            start_time=ms.execution_info.start_timestamp,
            search_attrs=dict(ms.execution_info.search_attributes),
        ))

    def _process_close(self, domain_id: str, workflow_id: str, run_id: str) -> None:
        """processCloseExecution: visibility close + parent notification
        (transfer_active_task_executor.go)."""
        try:
            ms = self.stores.execution.get_workflow(domain_id, workflow_id, run_id)
        except EntityNotExistsError:
            self._dropped_not_exists(SCOPE_QUEUE_TRANSFER)
            return
        info = ms.execution_info
        self.stores.visibility.record_closed(
            domain_id, workflow_id, run_id,
            close_time=self.clock.now(), close_status=info.close_status,
            workflow_type=info.workflow_type_name,
            start_time=info.start_timestamp)
        # notify parent (skip for continue-as-new, task_generator.go:996-999)
        if (ms.has_parent_execution()
                and info.close_status != CloseStatus.ContinuedAsNew):
            close_event = _CHILD_CLOSE_EVENT.get(CloseStatus(info.close_status))
            if close_event is not None:
                from .crosscluster import KIND_CHILD_CLOSED
                parked = (info.parent_domain_id != domain_id
                          and self._park_cross_cluster(
                              KIND_CHILD_CLOSED, domain_id, workflow_id,
                              run_id, 0, info.parent_domain_id,
                              info.parent_workflow_id,
                              target_run_id=info.parent_run_id,
                              parent_initiated_id=info.initiated_id,
                              close_event_type=int(close_event)))
                if not parked:
                    try:
                        parent_engine = self.router(info.parent_workflow_id)
                        parent_engine.on_child_closed(
                            info.parent_domain_id, info.parent_workflow_id,
                            info.parent_run_id, info.initiated_id, close_event)
                    except EntityNotExistsError:
                        self._dropped_not_exists(SCOPE_QUEUE_TRANSFER)
        self._apply_parent_close_policy(ms)

    def _apply_parent_close_policy(self, parent_ms) -> None:
        """Children of a closed parent stop per their policy
        (service/worker/parentclosepolicy/processor.go — the reference fans
        out through a system workflow for large child counts; the in-line
        fan-out here is the same semantic for in-process scale). Children
        still in pending_child_execution_info_ids are the ones that have
        not closed yet."""
        from ..core.enums import ParentClosePolicy
        info = parent_ms.execution_info
        for ci in list(parent_ms.pending_child_execution_info_ids.values()):
            policy = ParentClosePolicy(ci.parent_close_policy)
            if policy == ParentClosePolicy.Abandon or not ci.started_workflow_id:
                continue
            child_domain = ci.domain_id or info.domain_id
            # a child that continued-as-new moved past its pinned first
            # run: the policy applies to the CURRENT run of the chain
            run_id = ci.started_run_id or None
            if run_id is not None:
                try:
                    pinned = self.stores.execution.get_workflow(
                        child_domain, ci.started_workflow_id, run_id)
                    if (pinned.execution_info.close_status
                            == CloseStatus.ContinuedAsNew):
                        run_id = None
                except EntityNotExistsError:
                    run_id = None
            parent_domain = parent_ms.execution_info.domain_id
            if child_domain != parent_domain:
                from .crosscluster import (
                    KIND_POLICY_CANCEL,
                    KIND_POLICY_TERMINATE,
                )
                kind = (KIND_POLICY_TERMINATE
                        if policy == ParentClosePolicy.Terminate
                        else KIND_POLICY_CANCEL)
                if self._park_cross_cluster(
                        kind, parent_domain,
                        parent_ms.execution_info.workflow_id,
                        parent_ms.execution_info.run_id, 0, child_domain,
                        ci.started_workflow_id, target_run_id=run_id or ""):
                    continue
            try:
                child_engine = self.router(ci.started_workflow_id)
                if policy == ParentClosePolicy.Terminate:
                    child_engine.terminate_workflow(
                        child_domain, ci.started_workflow_id, run_id,
                        reason="parent-close-policy")
                elif policy == ParentClosePolicy.RequestCancel:
                    child_engine.request_cancel_workflow(
                        child_domain, ci.started_workflow_id, run_id)
            except (EntityNotExistsError, InvalidRequestError):
                # child already closed / cancel already requested
                self._dropped_not_exists(SCOPE_QUEUE_TRANSFER)

    def _park_cross_cluster(self, kind: str, domain_id: str,
                            workflow_id: str, run_id: str, event_id: int,
                            target_domain_id: str, target_workflow_id: str,
                            **extra) -> bool:
        """Park a task whose target domain is active on another cluster
        (cross_cluster_task_processor.go seam); True when parked. The
        source/target plumbing lives HERE so every executor parks with
        one call (and one place grows when the task schema does)."""
        if self.cross_cluster_publisher is None:
            return False
        from .crosscluster import CrossClusterTask, active_elsewhere
        target_cluster = active_elsewhere(self.stores, target_domain_id,
                                          self.cluster_name)
        if target_cluster is None:
            return False
        self.cross_cluster_publisher.publish(target_cluster, CrossClusterTask(
            kind=kind, source_domain_id=domain_id,
            source_workflow_id=workflow_id, source_run_id=run_id,
            event_id=event_id, target_domain_id=target_domain_id,
            target_workflow_id=target_workflow_id, **extra))
        return True

    def _start_child(self, engine: "HistoryEngine", domain_id: str,
                     workflow_id: str, run_id: str, task: GeneratedTask) -> None:
        """processStartChildExecution: start the child with parent linkage,
        then deliver ChildWorkflowExecutionStarted to the parent. A child
        domain active on ANOTHER cluster parks on the cross-cluster queue."""
        try:
            ms = self.stores.execution.get_workflow(domain_id, workflow_id, run_id)
        except EntityNotExistsError:
            self._dropped_not_exists(SCOPE_QUEUE_TRANSFER)
            return
        ci = ms.pending_child_execution_info_ids.get(task.event_id)
        if ci is None:
            return  # already resolved
        if ci.started_id != EMPTY_EVENT_ID:
            return  # redelivered task; child already started (idempotency)
        parent_info = ms.execution_info
        child_domain = ci.domain_id or domain_id
        if child_domain != domain_id:
            from .crosscluster import KIND_START_CHILD
            if self._park_cross_cluster(
                    KIND_START_CHILD, domain_id, workflow_id, run_id,
                    task.event_id, child_domain, ci.started_workflow_id,
                    workflow_type=ci.workflow_type_name,
                    task_list=ci.task_list or parent_info.task_list,
                    execution_timeout=parent_info.workflow_timeout,
                    decision_timeout=parent_info.decision_start_to_close_timeout,
                    parent_initiated_id=ci.initiated_id,
                    create_request_id=ci.create_request_id):
                return
        # redelivery-first probe: a fault between the child create and
        # the parent's started record leaves an existing run THIS
        # INITIATION made — adopt it whether it is still open or already
        # COMPLETED (a completed child must not be restarted as a
        # duplicate). The adoption key is the full parent linkage
        # (parent run + initiated event id) PLUS the create request id:
        # request ids alone are derived per event id (batch_request_id)
        # and repeat across a parent's continue-as-new/reset run chain,
        # so a later run re-initiating the same child id at a colliding
        # event id must start FRESH, never adopt the previous run's
        # child.
        child_run_id = None
        try:
            existing = self.stores.execution.get_current_run_id(
                child_domain, ci.started_workflow_id)
            child_info = self.stores.execution.get_workflow(
                child_domain, ci.started_workflow_id,
                existing).execution_info
            if (child_info.create_request_id == ci.create_request_id
                    and child_info.parent_run_id == run_id
                    and child_info.initiated_id == ci.initiated_id):
                child_run_id = existing
        except EntityNotExistsError:
            pass
        if child_run_id is None:
            child_engine = self.router(ci.started_workflow_id)
            try:
                child_run_id = child_engine.start_workflow(
                    domain_id=ci.domain_id or domain_id,
                    workflow_id=ci.started_workflow_id,
                    workflow_type=ci.workflow_type_name,
                    # the initiated event's task list wins; inheriting
                    # the parent's is the no-attribute fallback
                    task_list=ci.task_list or parent_info.task_list,
                    execution_timeout=parent_info.workflow_timeout,
                    decision_timeout=parent_info.decision_start_to_close_timeout,
                    parent=dict(
                        parent_workflow_domain_id=domain_id,
                        parent_workflow_id=workflow_id,
                        parent_run_id=run_id,
                        parent_initiated_event_id=ci.initiated_id,
                    ),
                    request_id=ci.create_request_id,
                )
            except WorkflowAlreadyStartedError:
                # a FOREIGN workflow squatting on the child's id: record
                # the start failure on the parent (the reference's
                # WorkflowAlreadyStarted child-start outcome) so the
                # pending child resolves instead of wedging the parent
                # until its execution timeout
                engine.on_child_start_failed(
                    domain_id, workflow_id, run_id, ci.initiated_id,
                    cause="WORKFLOW_ALREADY_RUNNING")
                return
        engine.on_child_started(domain_id, workflow_id, run_id,
                                ci.initiated_id, child_run_id)

    def _signal_external(self, engine: "HistoryEngine", domain_id: str,
                         workflow_id: str, run_id: str,
                         task: GeneratedTask) -> None:
        """processSignalExecution: deliver the signal, then record the
        outcome on the source workflow."""
        try:
            ms = self.stores.execution.get_workflow(domain_id, workflow_id, run_id)
        except EntityNotExistsError:
            self._dropped_not_exists(SCOPE_QUEUE_TRANSFER)
            return
        si = ms.pending_signal_info_ids.get(task.event_id)
        if si is None:
            return
        target_domain = task.target_domain_id or domain_id
        if target_domain != domain_id:
            from .crosscluster import KIND_SIGNAL
            if self._park_cross_cluster(
                    KIND_SIGNAL, domain_id, workflow_id, run_id,
                    task.event_id, target_domain, task.target_workflow_id,
                    target_run_id=task.target_run_id or "",
                    signal_name=si.signal_name):
                return
        failed = False
        try:
            target = self.router(task.target_workflow_id)
            target.signal_workflow(task.target_domain_id or domain_id,
                                   task.target_workflow_id,
                                   signal_name=si.signal_name,
                                   run_id=task.target_run_id or None)
        except EntityNotExistsError:
            failed = True
        engine.on_external_signaled(domain_id, workflow_id, run_id,
                                    task.event_id, failed=failed)

    def _cancel_external(self, engine: "HistoryEngine", domain_id: str,
                         workflow_id: str, run_id: str,
                         task: GeneratedTask) -> None:
        try:
            ms = self.stores.execution.get_workflow(domain_id, workflow_id, run_id)
        except EntityNotExistsError:
            self._dropped_not_exists(SCOPE_QUEUE_TRANSFER)
            return
        if task.event_id not in ms.pending_request_cancel_info_ids:
            return
        target_domain = task.target_domain_id or domain_id
        if target_domain != domain_id:
            from .crosscluster import KIND_CANCEL
            if self._park_cross_cluster(
                    KIND_CANCEL, domain_id, workflow_id, run_id,
                    task.event_id, target_domain, task.target_workflow_id,
                    target_run_id=task.target_run_id or ""):
                return
        failed = False
        try:
            target = self.router(task.target_workflow_id)
            target.request_cancel_workflow(task.target_domain_id or domain_id,
                                           task.target_workflow_id,
                                           run_id=task.target_run_id or None)
        except EntityNotExistsError:
            failed = True
        except InvalidRequestError:
            pass  # cancellation already requested on the target: delivered
        engine.on_external_cancel_delivered(domain_id, workflow_id, run_id,
                                            task.event_id, failed=failed)

    # ------------------------------------------------------------------
    # timer queue
    # ------------------------------------------------------------------

    def process_timers_once(self) -> int:
        """Fire all timers due at the current (mock) time."""
        now = self.clock.now()
        fired = 0
        for shard_id in self.controller.assigned_shards():
            engine = self.controller.engine_for_shard(shard_id)
            shard = engine.shard
            while True:
                from ..utils.dynamicconfig import KEY_QUEUE_BATCH_SIZE
                due = shard.read_timer_tasks(
                    now, ack_level=0,
                    batch=int(self.config.get(KEY_QUEUE_BATCH_SIZE)))
                if not due:
                    break
                for vis, task_id, domain_id, workflow_id, run_id, task in due:
                    self._execute_timer(engine, domain_id, workflow_id,
                                        run_id, task)
                    shard.update_timer_ack_level(task_id)
                    fired += 1
        self.metrics.inc(m.SCOPE_QUEUE_TIMER, m.M_TASKS_PROCESSED, fired)
        return fired

    def _execute_timer(self, engine: "HistoryEngine", domain_id: str,
                       workflow_id: str, run_id: str,
                       task: GeneratedTask) -> None:
        from .domain import DomainNotActiveError
        tt = TimerTaskType(task.task_type)
        try:
            if tt == TimerTaskType.UserTimer:
                engine.fire_user_timer(domain_id, workflow_id, run_id,
                                       task.event_id)
            elif tt == TimerTaskType.ActivityTimeout:
                engine.activity_timeout(domain_id, workflow_id, run_id,
                                        task.event_id, task.timeout_type,
                                        attempt=task.attempt)
            elif tt == TimerTaskType.DecisionTimeout:
                engine.decision_timeout(domain_id, workflow_id, run_id,
                                        task.event_id, task.timeout_type)
            elif tt == TimerTaskType.WorkflowTimeout:
                engine.timeout_workflow(domain_id, workflow_id, run_id)
            elif tt == TimerTaskType.WorkflowBackoffTimer:
                engine.schedule_first_decision(domain_id, workflow_id, run_id)
            elif tt == TimerTaskType.DeleteHistoryEvent:
                # retention elapsed: delete the closed run
                # (timer_task_executor deleteWorkflow; the scavenger in
                # engine/workers.py is the backstop for lost timers)
                engine.delete_workflow_execution(domain_id, workflow_id,
                                                 run_id)
            elif tt == TimerTaskType.ActivityRetryTimer:
                self._dispatch_activity_retry(domain_id, workflow_id, run_id,
                                              task)
        except EntityNotExistsError:
            self._dropped_not_exists(SCOPE_QUEUE_TIMER)
        except DomainNotActiveError:
            # a peer's promotion owns this workflow now (see the transfer
            # executor's drop): the winner's sweep regenerates the timer
            self.metrics.inc(SCOPE_QUEUE_TIMER, m.M_TASKS_DROPPED_STALE)

    def _dispatch_activity_retry(self, domain_id: str, workflow_id: str,
                                 run_id: str, task: GeneratedTask) -> None:
        """executeActivityRetryTimerTask (timer_active_task_executor.go):
        the backoff elapsed — re-dispatch the pending attempt straight to
        matching; no history event is written for a retry dispatch."""
        ms = self.stores.execution.get_workflow(domain_id, workflow_id, run_id)
        ai = ms.pending_activity_info_ids.get(task.event_id)
        if (ai is None or ai.started_id != EMPTY_EVENT_ID
                or ai.attempt != task.attempt):
            return  # attempt superseded or already running
        self.matching.add_activity_task(domain_id, ai.task_list,
                                        workflow_id, run_id, ai.schedule_id)
