"""Cross-cluster task executors: operations targeting a domain that is
ACTIVE ON ANOTHER CLUSTER.

Reference: service/history/task/cross_cluster_source_task_executor.go,
cross_cluster_target_task_executor.go, cross_cluster_task_processor.go —
when a transfer task's TARGET domain is active elsewhere (start a child
there, signal or cancel an execution there), the source cluster cannot
execute it locally at the right failover version. It parks the task on a
per-target-cluster queue; the TARGET cluster's processor pulls it
(target-driven, like the replication fetcher), executes the operation in
its own cluster, and the RESULT (child started / start failed / signal
delivered / target missing) is applied back onto the SOURCE workflow —
the same on_child_started / on_external_* appliers local execution uses.

The queue rides the durable store-queue seam (one ordered at-least-once
topic per target cluster), consistent with the history- and
domain-replication streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..utils.log import DEFAULT_LOGGER
from .persistence import EntityNotExistsError, WorkflowAlreadyStartedError

KIND_START_CHILD = "start_child"
KIND_SIGNAL = "signal"
KIND_CANCEL = "cancel"
#: child closed on its cluster → notify the parent on ITS cluster
KIND_CHILD_CLOSED = "child_closed"
#: parent-close-policy fan-out onto a child in another cluster
KIND_POLICY_TERMINATE = "policy_terminate"
KIND_POLICY_CANCEL = "policy_cancel"


def queue_name(target_cluster: str) -> str:
    return f"cross-cluster:{target_cluster}"


@dataclass(frozen=True)
class CrossClusterTask:
    """One parked operation (types.CrossClusterTaskRequest analog)."""

    kind: str
    source_domain_id: str
    source_workflow_id: str
    source_run_id: str
    event_id: int                 # initiated/signal/cancel event on source
    target_domain_id: str
    target_workflow_id: str
    target_run_id: str = ""
    signal_name: str = ""
    # start_child payload
    workflow_type: str = ""
    task_list: str = ""
    execution_timeout: int = 3600
    decision_timeout: int = 10
    parent_initiated_id: int = 0
    create_request_id: str = ""
    #: KIND_CHILD_CLOSED: the child's terminal EventType value
    close_event_type: int = 0


class CrossClusterPublisher:
    """Source side: park the task for the target cluster's processor."""

    def __init__(self, stores) -> None:
        self.stores = stores

    def publish(self, target_cluster: str, task: CrossClusterTask) -> None:
        self.stores.queue.enqueue(queue_name(target_cluster), task)


#: transient failures that must RETRY (stop the stream, keep the cursor)
#: instead of advancing past the task — mirrors the transfer pool's
#: retryable classification (queues.process_transfer_concurrent)
def _retryable() -> tuple:
    from .faults import TransientStoreError
    from .persistence import ConditionFailedError, ShardOwnershipLostError
    return (TransientStoreError, ShardOwnershipLostError,
            ConditionFailedError, ConnectionError)


class CrossClusterProcessor:
    """Target side: pull parked tasks, execute them in the target
    cluster, apply the result back onto the source workflow.

    Every task re-checks the target domain's CURRENT active cluster at
    execution time (against the TARGET side's domain view): a failover
    between parking and execution re-homes the task to the now-active
    cluster's queue instead of executing at a stale failover version."""

    def __init__(self, source_stores, target_router, source_router,
                 local_cluster: str, target_stores=None) -> None:
        self.source_stores = source_stores
        self.target_router = target_router    # workflow_id → target engine
        self.source_router = source_router    # workflow_id → source engine
        self.local_cluster = local_cluster
        #: the executing cluster's stores (domain activeness re-check);
        #: defaults to the source stores for single-store harnesses
        self.target_stores = (target_stores if target_stores is not None
                              else source_stores)
        self._cursor = 0
        self.log = DEFAULT_LOGGER.with_tags(component="cross-cluster",
                                            cluster=local_cluster)

    def _rehome_if_moved(self, task: CrossClusterTask) -> bool:
        """True when the target domain failed over after parking: the task
        re-parks for the NOW-active cluster and must not execute here."""
        now_active = active_elsewhere(self.target_stores,
                                      task.target_domain_id,
                                      self.local_cluster)
        if now_active is None:
            return False
        self.source_stores.queue.enqueue(queue_name(now_active), task)
        self.log.info("cross-cluster task re-homed", kind=task.kind,
                      to=now_active, source=task.source_workflow_id)
        return True

    def process_once(self) -> int:
        processed = 0
        while True:
            items = self.source_stores.queue.read(
                queue_name(self.local_cluster), self._cursor)
            if not items:
                return processed
            for index, task in items:
                try:
                    if not self._rehome_if_moved(task):
                        self._execute(task)
                except _retryable() as exc:
                    # transient: KEEP the cursor — the task retries on the
                    # next pass; dropping it would strand the source
                    # workflow waiting for a result forever
                    self.log.warning("cross-cluster task retrying",
                                     kind=task.kind, error=str(exc))
                    return processed
                except Exception as exc:
                    # poison: per-task isolation, advance past it
                    self.log.error("cross-cluster task failed",
                                   kind=task.kind,
                                   source=task.source_workflow_id,
                                   error=str(exc))
                self._cursor = index + 1
                processed += 1

    # -- execution + result application ---------------------------------

    def _source_engine(self, task: CrossClusterTask):
        return self.source_router(task.source_workflow_id)

    def _execute(self, task: CrossClusterTask) -> None:
        if task.kind == KIND_START_CHILD:
            self._start_child(task)
        elif task.kind == KIND_SIGNAL:
            self._signal(task)
        elif task.kind == KIND_CANCEL:
            self._cancel(task)
        elif task.kind == KIND_CHILD_CLOSED:
            self._child_closed(task)
        elif task.kind == KIND_POLICY_TERMINATE:
            self._policy(task, terminate=True)
        elif task.kind == KIND_POLICY_CANCEL:
            self._policy(task, terminate=False)
        else:
            raise ValueError(f"unknown cross-cluster task kind {task.kind!r}")

    def _start_child(self, task: CrossClusterTask) -> None:
        target = self.target_router(task.target_workflow_id)
        try:
            child_run_id = target.start_workflow(
                domain_id=task.target_domain_id,
                workflow_id=task.target_workflow_id,
                workflow_type=task.workflow_type,
                task_list=task.task_list,
                execution_timeout=task.execution_timeout,
                decision_timeout=task.decision_timeout,
                parent=dict(
                    parent_workflow_domain_id=task.source_domain_id,
                    parent_workflow_id=task.source_workflow_id,
                    parent_run_id=task.source_run_id,
                    parent_initiated_event_id=task.parent_initiated_id,
                ),
                request_id=task.create_request_id,
            )
        except WorkflowAlreadyStartedError:
            # At-least-once redelivery: when the running execution was
            # created by THIS task (same create request id — the
            # reference's StartRequestID dedup arm in startWorkflowHelper),
            # the earlier attempt's start committed but the result leg
            # failed; report started with the existing run, not failed.
            if task.create_request_id:
                try:
                    existing = target.get_mutable_state(
                        task.target_domain_id, task.target_workflow_id)
                    info = existing.execution_info
                    if info.create_request_id == task.create_request_id:
                        self._source_engine(task).on_child_started(
                            task.source_domain_id, task.source_workflow_id,
                            task.source_run_id, task.event_id, info.run_id)
                        return
                except EntityNotExistsError:
                    pass
            # a DIFFERENT execution holds the workflow id: the reference
            # records StartChildWorkflowExecutionFailed on the parent
            # (cross_cluster_source_task_executor response arm)
            self._source_engine(task).on_child_start_failed(
                task.source_domain_id, task.source_workflow_id,
                task.source_run_id, task.event_id)
            return
        self._source_engine(task).on_child_started(
            task.source_domain_id, task.source_workflow_id,
            task.source_run_id, task.event_id, child_run_id)

    def _signal(self, task: CrossClusterTask) -> None:
        failed = False
        try:
            # the task's identity doubles as a signal request id so a
            # redelivery after a transient result-leg failure does not
            # append a duplicate WorkflowExecutionSignaled event (the
            # reference's SignalRequestID dedup in AddSignalRequested)
            dedup = (f"xc-signal:{task.source_run_id}:{task.event_id}"
                     if task.source_run_id else None)
            self.target_router(task.target_workflow_id).signal_workflow(
                task.target_domain_id, task.target_workflow_id,
                signal_name=task.signal_name,
                run_id=task.target_run_id or None,
                request_id=dedup)
        except EntityNotExistsError:
            failed = True
        self._source_engine(task).on_external_signaled(
            task.source_domain_id, task.source_workflow_id,
            task.source_run_id, task.event_id, failed=failed)

    def _cancel(self, task: CrossClusterTask) -> None:
        from .history_engine import InvalidRequestError
        failed = False
        try:
            self.target_router(task.target_workflow_id).request_cancel_workflow(
                task.target_domain_id, task.target_workflow_id,
                run_id=task.target_run_id or None)
        except EntityNotExistsError:
            failed = True
        except InvalidRequestError:
            pass  # already cancel-requested: delivered
        self._source_engine(task).on_external_cancel_delivered(
            task.source_domain_id, task.source_workflow_id,
            task.source_run_id, task.event_id, failed=failed)


    def _child_closed(self, task: CrossClusterTask) -> None:
        """RecordChildExecutionCompleted across clusters: the child closed
        on ITS cluster; deliver the terminal event to the parent on its
        cluster (no response leg — the close already committed)."""
        from ..core.enums import EventType
        try:
            self.target_router(task.target_workflow_id).on_child_closed(
                task.target_domain_id, task.target_workflow_id,
                task.target_run_id, task.parent_initiated_id,
                EventType(task.close_event_type))
        except EntityNotExistsError:
            pass  # parent already gone (retention/terminate)

    def _policy(self, task: CrossClusterTask, terminate: bool) -> None:
        """Parent-close-policy fan-out onto a child whose domain is active
        on this cluster (applyParentClosePolicy across clusters)."""
        from .history_engine import InvalidRequestError
        try:
            target = self.target_router(task.target_workflow_id)
            if terminate:
                target.terminate_workflow(task.target_domain_id,
                                          task.target_workflow_id,
                                          task.target_run_id or None,
                                          reason="parent-close-policy")
            else:
                target.request_cancel_workflow(task.target_domain_id,
                                               task.target_workflow_id,
                                               task.target_run_id or None)
        except (EntityNotExistsError, InvalidRequestError):
            pass  # child already closed / already cancel-requested


def active_elsewhere(stores, target_domain_id: str,
                     local_cluster: str) -> Optional[str]:
    """The target cluster when `target_domain_id` is a GLOBAL domain
    active somewhere else; None when local execution is correct."""
    try:
        d = stores.domain.by_id(target_domain_id)
    except EntityNotExistsError:
        return None
    if len(d.clusters) > 1 and d.active_cluster != local_cluster:
        return d.active_cluster
    return None
