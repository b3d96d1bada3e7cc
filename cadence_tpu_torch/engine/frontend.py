"""Frontend: the public API gateway.

Reference: service/frontend/workflowHandler.go (domain CRUD :265-437,
polls :471/:580, StartWorkflowExecution :1940, Signal :2378,
Terminate/Cancel :2674-2783, List :2837, GetWorkflowExecutionHistory :2106,
DescribeTaskList :3593). Requests route to the owning history host via the
membership ring (client/history peer resolver analog) — in this in-process
cluster, via the cluster-wide router over all controllers.
"""
from __future__ import annotations

import uuid
from typing import Any, Callable, Dict, List, Optional

from ..core.enums import EMPTY_EVENT_ID, WorkflowState
from ..core.events import HistoryEvent, RetryPolicy
from ..oracle.mutable_state import MutableState
from ..utils import flightrecorder
from ..utils import metrics as m
from ..utils import tracing
from ..utils.clock import RealTimeSource
from ..utils.dynamicconfig import (
    KEY_FRONTEND_BURST,
    KEY_FRONTEND_DOMAIN_RPS,
    KEY_FRONTEND_RPS,
    KEY_HISTORY_PAGE_SIZE,
    KEY_RETENTION_DAYS_DEFAULT,
    KEY_VISIBILITY_PAGE_SIZE,
    DynamicConfig,
)
from ..utils.quotas import MultiStageRateLimiter, ServiceBusyError
from .authorization import (
    PERMISSION_ADMIN,
    PERMISSION_WRITE,
    AuthAttributes,
    NoopAuthorizer,
    check,
)
from .domain import (
    deprecate_domain,
    require_active,
    require_startable,
    update_domain,
)
from .history_engine import (
    Decision,
    HistoryEngine,
    InvalidRequestError,
    TaskToken,
)
from .limits import check_blob_size
from .matching import (
    TASK_LIST_TYPE_ACTIVITY,
    TASK_LIST_TYPE_DECISION,
    MatchedTask,
    MatchingEngine,
)
from .pagination import (
    HistoryPage,
    VisibilityPage,
    decode_token,
    encode_token,
)
from .archival import archiver_for
from .cluster import ClusterMetadata
from .persistence import DomainInfo, EntityNotExistsError, Stores, VisibilityRecord


class PollDecisionResponse:
    def __init__(self, token: Optional[TaskToken], history: List[HistoryEvent],
                 previous_started_event_id: int,
                 queries: Optional[List[tuple]] = None,
                 query_only: bool = False,
                 execution: Optional[tuple] = None) -> None:
        self.token = token
        self.history = history
        self.previous_started_event_id = previous_started_event_id
        #: (query_id, query_type, args) triples attached to this task
        self.queries = queries or []
        #: True for a query-only task (no decision token; answer via
        #: respond_query_task_completed)
        self.query_only = query_only
        #: (domain_id, workflow_id, run_id) for query-only responses
        self.execution = execution


class PollActivityResponse:
    def __init__(self, token: TaskToken, activity_id: str,
                 activity_type: str = "") -> None:
        self.token = token
        self.activity_id = activity_id
        self.activity_type = activity_type


class Frontend:
    def __init__(self, stores: Stores, matching: MatchingEngine,
                 router: Callable[[str], HistoryEngine],
                 config=None, metrics=None, time_source=None,
                 cluster_name: str = "primary") -> None:
        self.stores = stores
        self.matching = matching
        self.router = router
        self.cluster_name = cluster_name
        # authorization seam: Noop by default (reference posture); hosts
        # inject a real authorizer + per-connection actor identity
        self.authorizer = NoopAuthorizer()
        self.actor = ""
        #: the cluster group this frontend validates replication configs
        #: against (cluster/metadata.go); multi-cluster wiring replaces it
        self.cluster_meta = ClusterMetadata()
        #: set by multi-cluster wiring: domain mutations stream to peers
        #: (common/domain/replication_queue.go producer seam)
        self.domain_replication_publisher = None
        self.config = config if config is not None else DynamicConfig()
        self.metrics = metrics if metrics is not None else m.DEFAULT_REGISTRY
        clock = time_source if time_source is not None else RealTimeSource()
        # the quotas seat (common/quotas/ratelimiter.go:43): global +
        # per-domain token buckets with live-config limits; 0 = unlimited
        self.rate_limiter = MultiStageRateLimiter(
            clock,
            global_rps=lambda: self.config.get(KEY_FRONTEND_RPS),
            domain_rps=lambda d: self.config.get(KEY_FRONTEND_DOMAIN_RPS,
                                                 domain=d),
            burst=lambda: self.config.get(KEY_FRONTEND_BURST),
        )
        #: domains granted a per-domain metrics series, capped: the name
        #: comes straight from the request BEFORE the domain is validated,
        #: and a spray of junk domain names must never grow the registry
        #: (and every /metrics scrape) without bound — the same guard
        #: quotas.Collection applies to its buckets
        self._metric_domains: set = set()

    def _admit(self, domain: str, scope: str) -> None:
        """Admission control (quotas/multistageratelimiter.go seat): charge
        the request against the per-domain stage then the global stage.
        Over-limit requests shed with a typed ServiceBusyError carrying a
        retry-after estimate — overload degrades by rejecting cheaply at
        the door, never by queueing into latency collapse. Every decision
        lands on the `quotas` scope (admitted/shed + per-domain series),
        so a /metrics scrape shows WHICH domain is being shed."""
        try:
            self.rate_limiter.admit(domain)
        except ServiceBusyError:
            self.metrics.inc(scope, m.M_RATE_LIMITED)
            self.metrics.inc(m.SCOPE_QUOTAS, m.M_QUOTA_SHED)
            series = self._domain_series(m.M_QUOTA_SHED, domain)
            if series:
                self.metrics.inc(m.SCOPE_QUOTAS, series)
            flightrecorder.emit("quota-shed", domain=domain, api=scope)
            raise
        self.metrics.inc(m.SCOPE_QUOTAS, m.M_QUOTA_ADMITTED)
        series = self._domain_series(m.M_QUOTA_ADMITTED, domain)
        if series:
            self.metrics.inc(m.SCOPE_QUOTAS, series)

    #: per-domain quota series cap — beyond it only the totals count
    MAX_DOMAIN_SERIES = 256

    def _domain_series(self, name: str, domain: str) -> Optional[str]:
        """Per-domain series name, or None once the cap is hit (totals
        still count; only the per-domain breakdown saturates)."""
        if domain not in self._metric_domains:
            if len(self._metric_domains) >= self.MAX_DOMAIN_SERIES:
                return None
            self._metric_domains.add(domain)
        return m.domain_metric(name, domain)

    def _authorize(self, api: str, permission: str, domain: str = "") -> None:
        check(self.authorizer, AuthAttributes(api=api, permission=permission,
                                              domain=domain,
                                              actor=self.actor))

    # -- domains (workflowHandler.go:265-437) ------------------------------

    def register_domain(self, name: str, retention_days: int = 0,
                        is_active: bool = True,
                        clusters: tuple = ("primary",),
                        active_cluster: str = "primary",
                        failover_version: int = 0,
                        domain_id: str = "") -> str:
        """Domain CRUD (workflowHandler.go:265). Global domains pass the same
        domain_id on every cluster (the domain-replication invariant)."""
        self._authorize("RegisterDomain", PERMISSION_ADMIN, name)
        if retention_days <= 0:
            retention_days = int(self.config.get(KEY_RETENTION_DAYS_DEFAULT))
        domain_id = domain_id or str(uuid.uuid4())
        info = DomainInfo(
            domain_id=domain_id, name=name, retention_days=retention_days,
            is_active=is_active, active_cluster=active_cluster,
            clusters=tuple(clusters), failover_version=failover_version)
        self.stores.domain.register(info)
        # global domains replicate their REGISTRATION too (the processor's
        # register arm) — peers must not wait for the first update
        if self.domain_replication_publisher is not None and len(
                info.clusters) > 1:
            self.domain_replication_publisher.publish(info)
        return domain_id

    def describe_domain(self, name: str) -> DomainInfo:
        return self.stores.domain.by_name(name)

    def update_domain(self, name: str, retention_days: int = None,
                      description: str = None, clusters=None,
                      active_cluster: str = None,
                      history_archival_uri: str = None) -> DomainInfo:
        """UpdateDomain (workflowHandler.go:386): validated, live-effective
        (retention feeds the scavenger, failover-version bump stamps later
        events, archival URI arms archive-then-delete),
        notification-version ordered."""
        self._authorize("UpdateDomain", PERMISSION_ADMIN, name)
        info = update_domain(self.stores, name,
                             local_cluster=self.cluster_name,
                             meta=self.cluster_meta,
                             retention_days=retention_days,
                             description=description, clusters=clusters,
                             active_cluster=active_cluster,
                             history_archival_uri=history_archival_uri)
        if self.domain_replication_publisher is not None and len(
                info.clusters) > 1:
            self.domain_replication_publisher.publish(info)
        return info

    def deprecate_domain(self, name: str) -> DomainInfo:
        """DeprecateDomain: rejects new starts, running workflows finish."""
        self._authorize("DeprecateDomain", PERMISSION_ADMIN, name)
        info = deprecate_domain(self.stores, name)
        if self.domain_replication_publisher is not None and len(
                info.clusters) > 1:
            self.domain_replication_publisher.publish(info)
        return info

    def list_domains(self) -> List[DomainInfo]:
        return self.stores.domain.list_domains()

    # -- workflow lifecycle ------------------------------------------------

    @tracing.traced(m.SCOPE_FRONTEND_START)
    def start_workflow_execution(self, domain: str, workflow_id: str,
                                 workflow_type: str, task_list: str,
                                 execution_timeout: int = 3600,
                                 decision_timeout: int = 10,
                                 cron_schedule: str = "",
                                 first_decision_backoff: int = 0,
                                 retry_policy: Optional[RetryPolicy] = None,
                                 input_payload: bytes = b"",
                                 ) -> str:
        self._authorize("StartWorkflowExecution", PERMISSION_WRITE, domain)
        self._admit(domain, m.SCOPE_FRONTEND_START)
        self.metrics.inc(m.SCOPE_FRONTEND_START, m.M_REQUESTS)
        check_blob_size(input_payload, self.config,
                        "StartWorkflowExecution", domain,
                        metrics=self.metrics)
        info = self.stores.domain.by_name(domain)
        require_startable(info)
        require_active(info, self.cluster_name)
        domain_id = info.domain_id
        engine = self.router(workflow_id)
        return engine.start_workflow(
            domain_id=domain_id, workflow_id=workflow_id,
            workflow_type=workflow_type, task_list=task_list,
            execution_timeout=execution_timeout,
            decision_timeout=decision_timeout,
            cron_schedule=cron_schedule,
            first_decision_backoff=first_decision_backoff,
            retry_policy=retry_policy,
            input_payload=input_payload,
        )

    @tracing.traced(m.SCOPE_FRONTEND_SIGNAL)
    def signal_workflow_execution(self, domain: str, workflow_id: str,
                                  signal_name: str,
                                  run_id: Optional[str] = None,
                                  request_id: Optional[str] = None) -> None:
        """request_id (SignalWorkflowExecutionRequest.RequestId) dedups
        client retries: a signal already applied under the same id no-ops."""
        self._authorize("SignalWorkflowExecution", PERMISSION_WRITE, domain)
        self._admit(domain, m.SCOPE_FRONTEND_SIGNAL)
        info = self.stores.domain.by_name(domain)
        require_active(info, self.cluster_name)
        self.router(workflow_id).signal_workflow(info.domain_id, workflow_id,
                                                 signal_name, run_id,
                                                 request_id=request_id)

    def signal_with_start_workflow_execution(
            self, domain: str, workflow_id: str, signal_name: str,
            workflow_type: str, task_list: str,
            execution_timeout: int = 3600, decision_timeout: int = 10,
            cron_schedule: str = "", retry_policy=None,
            request_id: Optional[str] = None) -> str:
        """SignalWithStartWorkflowExecution (workflowHandler.go:2494):
        signal the running execution, or atomically start one whose first
        transaction carries the signal. Returns the run ID signaled or
        started. `request_id` dedups client retries on BOTH arms (the
        start's create request id and the signal's at-least-once set)."""
        self._authorize("SignalWithStartWorkflowExecution", PERMISSION_WRITE,
                        domain)
        self._admit(domain, m.SCOPE_FRONTEND_SIGNAL)
        info = self.stores.domain.by_name(domain)
        require_startable(info)
        require_active(info, self.cluster_name)
        return self.router(workflow_id).signal_with_start_workflow(
            info.domain_id, workflow_id, signal_name, workflow_type,
            task_list, execution_timeout=execution_timeout,
            decision_timeout=decision_timeout, cron_schedule=cron_schedule,
            retry_policy=retry_policy, request_id=request_id)

    def request_cancel_workflow_execution(self, domain: str, workflow_id: str,
                                          run_id: Optional[str] = None) -> None:
        self._authorize("RequestCancelWorkflowExecution", PERMISSION_WRITE,
                        domain)
        self._admit(domain, m.SCOPE_FRONTEND_SIGNAL)
        info = self.stores.domain.by_name(domain)
        require_active(info, self.cluster_name)
        self.router(workflow_id).request_cancel_workflow(info.domain_id,
                                                         workflow_id, run_id)

    def terminate_workflow_execution(self, domain: str, workflow_id: str,
                                     run_id: Optional[str] = None,
                                     reason: str = "") -> None:
        self._authorize("TerminateWorkflowExecution", PERMISSION_WRITE, domain)
        self._admit(domain, m.SCOPE_FRONTEND_SIGNAL)
        info = self.stores.domain.by_name(domain)
        require_active(info, self.cluster_name)
        self.router(workflow_id).terminate_workflow(info.domain_id,
                                                    workflow_id, run_id,
                                                    reason)

    def reset_workflow_execution(self, domain: str, workflow_id: str,
                                 decision_finish_event_id: int,
                                 run_id: Optional[str] = None,
                                 reason: str = "") -> str:
        """ResetWorkflowExecution (workflowHandler.go:2726): returns the new
        run ID."""
        self._authorize("ResetWorkflowExecution", PERMISSION_WRITE, domain)
        self._admit(domain, m.SCOPE_FRONTEND_RESET)
        info = self.stores.domain.by_name(domain)
        require_active(info, self.cluster_name)
        domain_id = info.domain_id
        return self.router(workflow_id).reset_workflow(
            domain_id, workflow_id, run_id,
            decision_finish_event_id=decision_finish_event_id, reason=reason)

    # -- worker polls ------------------------------------------------------

    @tracing.traced(m.SCOPE_FRONTEND_POLL_DECISION)
    def poll_for_decision_task(self, domain: str, task_list: str,
                               wait_seconds: float = 0, identity: str = ""
                               ) -> Optional[PollDecisionResponse]:
        """PollForDecisionTask (workflowHandler.go:580). With
        `wait_seconds` > 0 the poll LONG-POLLS: an empty task list parks
        the poll for sync-match instead of returning immediately (the
        reference's long-poll transport over taskListManager's matcher).
        `identity` lands in DescribeTaskList's poller history."""
        domain_id = self.stores.domain.by_name(domain).domain_id
        task = self.matching.poll_and_wait_decision(domain_id, task_list,
                                                    wait_seconds,
                                                    identity=identity)
        if task is None:
            return None
        try:
            engine = self.router(task.workflow_id)
        except Exception:
            # routing failed after the two-phase pop (shard mid-rebalance):
            # the task must not strand in the in-flight ledger, or it pins
            # the task-list GC level forever
            self.matching.requeue_task(task, TASK_LIST_TYPE_DECISION)
            raise
        key = (task.domain_id, task.workflow_id, task.run_id)
        if task.query_id:
            # query-only task: no history mutation, no decision token;
            # ship the buffered queries with current history so the worker
            # can answer (matchingEngine QueryWorkflow → worker)
            history = engine.get_history(task.domain_id, task.workflow_id,
                                         task.run_id)
            return PollDecisionResponse(
                token=None, history=history, previous_started_event_id=0,
                queries=engine.queries.attach(key), query_only=True,
                execution=key)
        try:
            token = engine.record_decision_task_started(
                task.domain_id, task.workflow_id, task.run_id,
                task.schedule_id, request_id=str(uuid.uuid4()))
        except (InvalidRequestError, EntityNotExistsError):
            # stale task (decision handled / run never committed) — ack it
            # away so its persisted row doesn't pin the task-list GC level
            self.matching.complete_task(task, TASK_LIST_TYPE_DECISION)
            return None
        except Exception:
            # transient engine/store failure: the consumed task must not be
            # lost — requeue for redelivery (matching acks only after a
            # successful RecordDecisionTaskStarted)
            self.matching.requeue_task(task, TASK_LIST_TYPE_DECISION)
            raise
        # successful engine write: second phase of the ack deletes the row
        self.matching.complete_task(task, TASK_LIST_TYPE_DECISION)
        ms = engine.get_mutable_state(task.domain_id, task.workflow_id,
                                      task.run_id)
        history = engine.get_history(task.domain_id, task.workflow_id,
                                     task.run_id)
        return PollDecisionResponse(
            token=token, history=history,
            previous_started_event_id=ms.execution_info.last_processed_event,
            queries=engine.queries.attach(key), execution=key)

    def respond_decision_task_completed(self, token: TaskToken,
                                        decisions: List[Decision],
                                        sticky_task_list: str = "",
                                        sticky_schedule_to_start_timeout: int = 0,
                                        query_results: Optional[Dict[str, bytes]] = None
                                        ) -> None:
        self.router(token.workflow_id).respond_decision_task_completed(
            token, decisions, sticky_task_list=sticky_task_list,
            sticky_schedule_to_start_timeout=sticky_schedule_to_start_timeout,
            query_results=query_results)
        # queries still buffered after the completion (arrived mid-decision,
        # unanswered by this worker) must not wait for a decision that may
        # never come: dispatch them directly (the reference forwards leftover
        # buffered queries through matching after decision completion)
        self._dispatch_buffered_queries(token.domain_id, token.workflow_id,
                                        token.run_id)

    def _dispatch_buffered_queries(self, domain_id: str, workflow_id: str,
                                   run_id: str) -> None:
        engine = self.router(workflow_id)
        key = (domain_id, workflow_id, run_id)
        buffered = engine.queries.buffered_ids(key)
        if not buffered:
            return
        try:
            ms = engine.get_mutable_state(domain_id, workflow_id, run_id)
        except Exception:
            return
        info = ms.execution_info
        if info.state == WorkflowState.Completed:
            engine.queries.fail_all(key, "workflow execution closed")
            return
        if info.decision_schedule_id != EMPTY_EVENT_ID:
            return  # a decision is coming; queries attach to its poll
        # one trigger task suffices: the poll's attach() ships every
        # buffered query. Always the NORMAL task list — a stale sticky
        # list would park the query behind a dead worker with no
        # schedule-to-start fallback (query tasks have no timer)
        self.matching.add_query_task(domain_id, info.task_list,
                                     workflow_id, run_id, buffered[0])

    # -- consistent query (workflowHandler.go:3454 QueryWorkflow →
    # query/registry.go buffered queries) ----------------------------------

    def query_workflow(self, domain: str, workflow_id: str, query_type: str,
                       args: bytes = b"", run_id: Optional[str] = None) -> str:
        """Register a query; returns its ID. A workflow with a decision
        pending or in flight answers with that decision's completion
        (consistent query); an idle workflow gets a query-only task
        dispatched directly through matching."""
        self._admit(domain, m.SCOPE_FRONTEND_QUERY)
        domain_id = self.stores.domain.by_name(domain).domain_id
        engine = self.router(workflow_id)
        ms = engine.get_mutable_state(domain_id, workflow_id, run_id)
        info = ms.execution_info
        if info.state == WorkflowState.Completed:
            raise InvalidRequestError("workflow execution already completed")
        key = (domain_id, workflow_id, info.run_id)
        query_id = engine.queries.buffer(key, query_type, args)
        if info.decision_schedule_id == EMPTY_EVENT_ID:
            # always the NORMAL task list: a stale sticky list would park
            # the query behind a dead worker (query tasks carry no
            # schedule-to-start fallback timer)
            self.matching.add_query_task(domain_id, info.task_list,
                                         workflow_id, info.run_id, query_id)
        return query_id

    def get_query_result(self, domain: str, workflow_id: str, query_id: str,
                         run_id: Optional[str] = None):
        """(state, result, failure) of a registered query."""
        domain_id = self.stores.domain.by_name(domain).domain_id
        engine = self.router(workflow_id)
        if run_id is None:
            run_id = self.stores.execution.get_current_run_id(
                domain_id, workflow_id)
        # engine-side unpack: the registry's PendingQuery carries a
        # threading.Event, so the OBJECT must never cross the wire when
        # the owner is a remote host — only the plain result tuple does
        return engine.query_result_tuple(domain_id, workflow_id, run_id,
                                         query_id)

    def respond_query_task_completed(self, execution: tuple, query_id: str,
                                     result: bytes) -> None:
        """Answer a query-only task (RespondQueryTaskCompleted analog)."""
        self.router(execution[1]).queries.complete(execution, query_id, result)

    def poll_for_activity_task(self, domain: str, task_list: str,
                               wait_seconds: float = 0, identity: str = ""
                               ) -> Optional[PollActivityResponse]:
        domain_id = self.stores.domain.by_name(domain).domain_id
        task = self.matching.poll_and_wait_activity(domain_id, task_list,
                                                    wait_seconds,
                                                    identity=identity)
        if task is None:
            return None
        try:
            engine = self.router(task.workflow_id)
        except Exception:
            self.matching.requeue_task(task, TASK_LIST_TYPE_ACTIVITY)
            raise
        try:
            token = engine.record_activity_task_started(
                task.domain_id, task.workflow_id, task.run_id,
                task.schedule_id, request_id=str(uuid.uuid4()))
        except (InvalidRequestError, EntityNotExistsError):
            # stale (timed out / closed / never committed): ack it away
            self.matching.complete_task(task, TASK_LIST_TYPE_ACTIVITY)
            return None
        except Exception:
            self.matching.requeue_task(task, TASK_LIST_TYPE_ACTIVITY)
            raise
        self.matching.complete_task(task, TASK_LIST_TYPE_ACTIVITY)
        ms = engine.get_mutable_state(task.domain_id, task.workflow_id,
                                      task.run_id)
        ai = ms.pending_activity_info_ids.get(task.schedule_id)
        return PollActivityResponse(token=token,
                                    activity_id=ai.activity_id if ai else "")

    def respond_activity_task_completed(self, token: TaskToken,
                                        result: bytes = b"") -> None:
        self.router(token.workflow_id).respond_activity_task_completed(
            token, result)

    def respond_activity_task_failed(self, token: TaskToken,
                                     reason: str = "") -> None:
        self.router(token.workflow_id).respond_activity_task_failed(token, reason)

    # -- reads -------------------------------------------------------------

    def get_workflow_execution_history(self, domain: str, workflow_id: str,
                                       run_id: Optional[str] = None,
                                       wait_for_new_event: bool = False,
                                       last_event_id: int = 0,
                                       timeout: float = 10.0
                                       ) -> List[HistoryEvent]:
        """GetWorkflowExecutionHistory (workflowHandler.go:2106). With
        `wait_for_new_event`, the call LONG-POLLS: it blocks on the history
        notifier until events beyond `last_event_id` exist or the workflow
        closes (the reference's close-event wait policy), instead of
        busy-reading."""
        # admission charges at ENTRY (one token per call, long-poll or
        # not): a parked long-poll holds a notifier slot, not a quota
        self._admit(domain, m.SCOPE_FRONTEND_READ)
        info = self.stores.domain.by_name(domain)
        domain_id = info.domain_id
        engine = self.router(workflow_id)

        def read_paged() -> List[HistoryEvent]:
            # the full convenience read drives the RANGED store read in
            # pages (state_rebuilder.go:114's paginated replay posture):
            # no single store call moves unbounded bytes
            cap = int(self.config.get(KEY_HISTORY_PAGE_SIZE, domain=domain))
            out: List[HistoryEvent] = []
            from_id = 1
            while True:
                page = self.stores.history.read_events_range(
                    domain_id, workflow_id, run_id, from_id, cap)
                out.extend(page)
                if len(page) < cap:
                    return out
                from_id = page[-1].id + 1

        try:
            if run_id is None:
                run_id = self.stores.execution.get_current_run_id(domain_id,
                                                                  workflow_id)
            events = read_paged()
        except EntityNotExistsError:
            # read-through to the archive: a retention-scavenged run whose
            # domain archives stays readable (common/archiver Get path).
            # With no run_id (the scavenge also dropped the current-run
            # pointer), the most recently closed archived run serves.
            archiver = archiver_for(info.history_archival_uri)
            if archiver is None:
                raise
            if run_id is None:
                archived = archiver.runs(domain_id, workflow_id)
                if not archived:
                    raise
                run_id = archived[0]
            return [e for b in archiver.read(domain_id, workflow_id, run_id)
                    for e in b.events]
        if wait_for_new_event and (not events or events[-1].id <= last_event_id):
            # an event BEYOND last_event_id exists iff the published
            # next_event_id reaches last_event_id + 2
            engine.notifier.wait_for((domain_id, workflow_id, run_id),
                                     last_event_id + 2, timeout=timeout)
            events = read_paged()
        return events

    def get_workflow_execution_history_page(self, domain: str,
                                            workflow_id: str,
                                            run_id: Optional[str] = None,
                                            page_size: int = 0,
                                            next_page_token: Optional[bytes]
                                            = None):
        """Paginated history read (workflowHandler.go:3745-3811 getHistory
        with nextPageToken): at most `page_size` events per call (the
        configured default/cap bounds it), with an opaque resume token.
        The store read itself is RANGED, so a page never moves more than
        page_size events — the contract the CLI, the archiver, and any
        long-history consumer page through."""

        cap = int(self.config.get(KEY_HISTORY_PAGE_SIZE, domain=domain))
        page_size = min(page_size, cap) if page_size > 0 else cap
        info = self.stores.domain.by_name(domain)
        domain_id = info.domain_id
        from_id = 1
        if next_page_token:
            tok = decode_token(next_page_token)
            run_id = tok["run_id"]
            from_id = int(tok["next_event_id"])
        elif run_id is None:
            run_id = self.stores.execution.get_current_run_id(domain_id,
                                                              workflow_id)
        events = self.stores.history.read_events_range(
            domain_id, workflow_id, run_id, from_id, page_size + 1)
        more = len(events) > page_size
        events = events[:page_size]
        token = (encode_token({"run_id": run_id,
                               "next_event_id": events[-1].id + 1})
                 if events and more else None)
        return HistoryPage(events, token, run_id)

    def describe_workflow_execution(self, domain: str, workflow_id: str,
                                    run_id: Optional[str] = None
                                    ) -> MutableState:
        self._admit(domain, m.SCOPE_FRONTEND_READ)
        domain_id = self.stores.domain.by_name(domain).domain_id
        return self.router(workflow_id).get_mutable_state(domain_id,
                                                          workflow_id, run_id)

    def list_open_workflow_executions(self, domain: str) -> List[VisibilityRecord]:
        domain_id = self.stores.domain.by_name(domain).domain_id
        return self.stores.visibility.list_open(domain_id)

    def list_closed_workflow_executions(self, domain: str) -> List[VisibilityRecord]:
        domain_id = self.stores.domain.by_name(domain).domain_id
        return self.stores.visibility.list_closed(domain_id)

    def list_workflow_executions(self, domain: str, query: str = ""
                                 ) -> List[VisibilityRecord]:
        """ListWorkflowExecutions with a query (workflowHandler.go:2837):
        SQL-ish filters over built-in columns AND custom search attributes
        (engine/visibility_query.py grammar). Index-planned: the query's
        equality hints intersect the store's (type, status) indexes."""
        domain_id = self.stores.domain.by_name(domain).domain_id
        return self.stores.visibility.query(domain_id, query)

    # ScanWorkflowExecutions (workflowHandler.go:3200) shares semantics
    # with List in this store (no pagination-ordering split to preserve)
    scan_workflow_executions = list_workflow_executions

    def list_workflow_executions_page(self, domain: str, query: str = "",
                                      page_size: int = 0,
                                      next_page_token: Optional[bytes] = None):
        """Paginated List/Scan: StartTime-DESC pages with an opaque resume
        token (the ES search_after token reframed onto the store's
        time-ordered index)."""

        cap = int(self.config.get(KEY_VISIBILITY_PAGE_SIZE, domain=domain))
        page_size = min(page_size, cap) if page_size > 0 else cap
        domain_id = self.stores.domain.by_name(domain).domain_id
        cursor = (decode_token(next_page_token)["after"]
                  if next_page_token else None)
        records, raw = self.stores.visibility.query_page(
            domain_id, query, page_size, cursor)
        token = encode_token({"after": list(raw)}) if raw else None
        return VisibilityPage(records, token)

    scan_workflow_executions_page = list_workflow_executions_page

    def count_workflow_executions(self, domain: str, query: str = "") -> int:
        """CountWorkflowExecutions (workflowHandler.go:3322)."""
        domain_id = self.stores.domain.by_name(domain).domain_id
        return self.stores.visibility.count(domain_id, query)

    def describe_task_list(self, domain: str, task_list: str,
                           task_type: int = TASK_LIST_TYPE_DECISION
                           ) -> Dict[str, int]:
        domain_id = self.stores.domain.by_name(domain).domain_id
        return self.matching.describe_task_list(domain_id, task_list, task_type)
