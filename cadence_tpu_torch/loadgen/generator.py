"""Open-loop load generator: scheduled arrivals, intended-time latency.

The defining property (and the reason bench.py cannot measure a latency
trajectory): this driver is OPEN-LOOP. The schedule of intended send
times is fixed before the run (mixes.build_schedule), and every op's
latency is measured from its INTENDED send time — not from when a free
thread finally got around to sending it. When the server (or the
dispatch pool) falls behind, the backlog shows up as GROWING latency,
exactly as queueing users would experience it; a closed-loop driver
would instead slow its own arrivals and report a flattering
service-time distribution. That failure mode — coordinated omission —
is structurally impossible here because the measurement anchor never
depends on completions.

Two latency series per op are recorded so the distinction stays
observable: `latency` (completion − intended send) is the user-facing
number the SLOs gate on; `service-latency` (completion − actual send)
is the server-side diagnostic. A stalled server inflates the first and
not the second — tests/test_loadgen.py pins exactly that.

Sheds are first-class outcomes, not errors, and their ORIGIN is kept
apart: a typed quota rejection (`quotas.ServiceBusyError`, raised by
the server's admission door and pickled back over the wire) counts
into `shed`, mirroring the server-side `quotas/shed` counters
one-for-one; a client-side circuit-breaker shed
(`circuitbreaker.ServiceBusy`, raised before the request ever reaches
a host) counts into `shed_busy`. Conflating them would make the
overload gate's client↔server shed comparison flaky under wire chaos —
a tripped breaker sheds on the client with no matching server counter.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..utils import metrics as m
from ..utils.circuitbreaker import ServiceBusy
from ..utils.quotas import ServiceBusyError
from .mixes import (
    OP_COUNT,
    OP_CRON_START,
    OP_LIST,
    OP_LONGPOLL,
    OP_QUERY,
    OP_RESET,
    OP_RETRY_START,
    OP_SCAN,
    OP_SIGNAL,
    OP_SIGNAL_WITH_START,
    OP_START,
    DomainPlan,
    ScheduledOp,
    pool_workflow_ids,
    trace_digest,
)

#: generator workflow types / task lists (per-domain task lists keep the
#: churn population — which workers complete — apart from the pool
#: population, which must stay open so signals/resets always land)
CHURN_TYPE = "lg-churn"
POOL_TYPE = "lg-pool"


def churn_task_list(domain: str) -> str:
    return f"lg-churn-{domain}"


def pool_task_list(domain: str) -> str:
    return f"lg-pool-{domain}"


@dataclass
class OpStats:
    sent: int = 0
    ok: int = 0
    #: server quota rejections (typed ServiceBusyError) — the count the
    #: server-side quotas/shed counters must agree with
    shed: int = 0
    #: client-side circuit-breaker sheds (no matching server counter)
    shed_busy: int = 0
    errors: int = 0
    error_types: Dict[str, int] = field(default_factory=dict)


@dataclass
class LoadReport:
    """One run's outcome: counts + the registry holding the latency
    distributions (per-op scopes `loadgen.<kind>`, per-domain series via
    domain_metric)."""

    duration_s: float
    scheduled: int
    trace_digest: str
    stats: Dict[Tuple[str, str], OpStats]   # (kind, domain) → counts
    registry: object                        # MetricsRegistry
    completed_churn: int = 0
    max_retry_after_s: float = 0.0

    def totals(self, domain: Optional[str] = None) -> OpStats:
        out = OpStats()
        for (kind, d), s in self.stats.items():
            if domain is not None and d != domain:
                continue
            out.sent += s.sent
            out.ok += s.ok
            out.shed += s.shed
            out.shed_busy += s.shed_busy
            out.errors += s.errors
        return out

    def percentiles(self, kind: str, domain: Optional[str] = None,
                    metric: str = "latency") -> Dict[str, float]:
        """{p50, p99, p999} seconds for one op kind (optionally one
        domain's series) from the registry's fixed-bucket histogram."""
        name = metric if domain is None else m.domain_metric(metric, domain)
        hist = self.registry.histogram(f"{m.SCOPE_LOADGEN_PREFIX}.{kind}",
                                       name)
        return {"p50": hist.percentile(0.5), "p99": hist.percentile(0.99),
                "p999": hist.percentile(0.999)}

    def as_dict(self) -> dict:
        per_op: Dict[str, dict] = {}
        for (kind, domain), s in sorted(self.stats.items()):
            pct = self.percentiles(kind, domain)
            per_op.setdefault(kind, {})[domain] = {
                "sent": s.sent, "ok": s.ok, "shed": s.shed,
                "shed_busy": s.shed_busy,
                "errors": s.errors, "error_types": dict(s.error_types),
                "p50_ms": round(pct["p50"] * 1000, 3),
                "p99_ms": round(pct["p99"] * 1000, 3),
                "p999_ms": round(pct["p999"] * 1000, 3),
            }
        t = self.totals()
        return {
            "duration_s": round(self.duration_s, 3),
            "scheduled": self.scheduled,
            "sent": t.sent, "ok": t.ok, "shed": t.shed,
            "shed_busy": t.shed_busy, "errors": t.errors,
            "completed_churn": self.completed_churn,
            "max_retry_after_s": round(self.max_retry_after_s, 6),
            "trace_digest": self.trace_digest,
            "per_op": per_op,
        }


class DecisionCompleters:
    """The worker fleet for the churn population: per-domain poller
    threads completing every decision with CompleteWorkflowExecution
    (host/taskpoller.go shape) — churn workflows CLOSE, building the
    completed-workflow population the checksum verify runs over."""

    def __init__(self, client_factory: Callable[[], object],
                 domains: Sequence[str], per_domain: int = 2,
                 poll_wait: float = 0.3) -> None:
        self._factory = client_factory
        self._domains = list(domains)
        self._per_domain = per_domain
        self._poll_wait = poll_wait
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self.completed = 0

    def start(self) -> None:
        for domain in self._domains:
            for i in range(self._per_domain):
                t = threading.Thread(target=self._loop, args=(domain,),
                                     daemon=True,
                                     name=f"lg-completer-{domain}-{i}")
                t.start()
                self._threads.append(t)

    def _loop(self, domain: str) -> None:
        from ..core.enums import DecisionType
        from ..engine.history_engine import Decision
        client = self._factory()
        tl = churn_task_list(domain)
        while not self._stop.is_set():
            try:
                resp = client.poll_for_decision_task(
                    domain, tl, wait_seconds=self._poll_wait,
                    identity="loadgen-completer")
                if resp is None or resp.token is None:
                    continue
                client.respond_decision_task_completed(resp.token, [
                    Decision(DecisionType.CompleteWorkflowExecution,
                             {"result": b"lg-done"})])
                with self._lock:
                    self.completed += 1
            except Exception:
                # transient cluster trouble (chaos, shard move): the next
                # poll retries; the completer must never die mid-run
                time.sleep(0.05)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)


class LoadGenerator:
    """Drive one schedule against frontend-shaped clients, open-loop.

    `clients` is a sequence of frontend duck-types (in-process Frontend,
    Onebox.frontend, or wire FrontendClients — one per host spreads the
    traffic the way a production LB would); ops round-robin across them
    by schedule index, deterministically."""

    def __init__(self, clients: Sequence[object],
                 schedule: Sequence[ScheduledOp],
                 plans: Sequence[DomainPlan],
                 registry=None, workers: int = 16,
                 longpoll_timeout_s: float = 0.25,
                 pump: Optional[Callable[[], object]] = None,
                 request_salt: str = "") -> None:
        if not clients:
            raise ValueError("need at least one client")
        self.clients = list(clients)
        #: disambiguates signal request-ids across RUNS sharing a pool:
        #: a replicated pool carries phase-1 request ids in its dedup
        #: sets, so a post-failover phase against the same pool must salt
        #: its own ids or its signals silently no-op as "redeliveries"
        self.request_salt = request_salt
        self.schedule = list(schedule)
        self.plans = list(plans)
        from ..utils.metrics import MetricsRegistry
        self.registry = registry if registry is not None else MetricsRegistry()
        self.workers = workers
        self.longpoll_timeout_s = longpoll_timeout_s
        #: in-process clusters (Onebox) need their queues pumped; wire
        #: clusters pump themselves (pass None)
        self.pump = pump
        self._cursor = 0
        self._cursor_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats: Dict[Tuple[str, str], OpStats] = {}
        self._max_retry_after = 0.0
        self._abort = threading.Event()

    # -- population setup --------------------------------------------------

    def prepare(self, setup_deadline_s: float = 60.0) -> None:
        """Register domains and seed the pool population: every pool
        workflow is started on the pool task list and gets exactly ONE
        decision completed (empty decision list — the workflow stays
        open, no further decision pending), so reset ops always have the
        event-4 decision boundary to fork at and signals always land."""
        client = self.clients[0]
        for plan in self.plans:
            try:
                client.register_domain(plan.domain)
            except Exception:
                pass  # already registered
            pool = pool_workflow_ids(plan)
            deadline = time.monotonic() + setup_deadline_s
            for wf in pool:
                while True:
                    try:
                        client.start_workflow_execution(
                            plan.domain, wf, POOL_TYPE,
                            pool_task_list(plan.domain),
                            execution_timeout=24 * 3600)
                        break
                    except (ServiceBusyError, ServiceBusy) as exc:
                        # a shed is NOT "already started": back off and
                        # retry inside the setup deadline, else the pool
                        # silently stays unseeded and the poll loop below
                        # times out with a misleading error
                        if time.monotonic() >= deadline:
                            raise
                        retry = float(getattr(exc, "retry_after_s", 0.0)
                                      or 0.0)
                        time.sleep(min(max(retry, 0.05), 1.0))
                    except Exception:
                        break  # already started (re-prepare)
            self._pump()
            pending: Set[str] = set(pool)
            while pending and time.monotonic() < deadline:
                self._pump()
                resp = client.poll_for_decision_task(
                    plan.domain, pool_task_list(plan.domain),
                    wait_seconds=0.2, identity="loadgen-seeder")
                if resp is None or resp.token is None:
                    continue
                client.respond_decision_task_completed(resp.token, [])
                pending.discard(resp.token.workflow_id)
            if pending:
                raise TimeoutError(
                    f"pool workflows never seeded: {sorted(pending)}")
        self._warm_reset_path(setup_deadline_s)

    def _warm_reset_path(self, setup_deadline_s: float) -> None:
        """The FIRST reset routed to a host pays that process's lazy
        device-runtime init + rebuild-kernel compile (tens of seconds on
        a cold process) — deployment warmup, not steady-state latency,
        so it must never land inside the measured window. Reset every
        pool workflow once (the pool spreads across shards, so every
        shard-owner host compiles) and re-complete the forked runs'
        decisions, restoring the seeded-pool invariant (one completed
        decision, boundary at event 4, nothing pending)."""
        client = self.clients[0]
        for plan in self.plans:
            if plan.mix.weights.get(OP_RESET, 0) <= 0:
                continue
            pool = pool_workflow_ids(plan)
            for wf in pool:
                client.reset_workflow_execution(
                    plan.domain, wf, decision_finish_event_id=4,
                    reason="loadgen-warmup")
            self._pump()
            pending = set(pool)
            deadline = time.monotonic() + setup_deadline_s
            while pending and time.monotonic() < deadline:
                self._pump()
                resp = client.poll_for_decision_task(
                    plan.domain, pool_task_list(plan.domain),
                    wait_seconds=0.2, identity="loadgen-warmup")
                if resp is None or resp.token is None:
                    continue
                client.respond_decision_task_completed(resp.token, [])
                pending.discard(resp.token.workflow_id)
            if pending:
                raise TimeoutError(
                    f"warmup resets never completed: {sorted(pending)}")

    def _pump(self) -> None:
        if self.pump is not None:
            self.pump()
        else:
            time.sleep(0.01)

    # -- the open-loop run -------------------------------------------------

    def run(self) -> LoadReport:
        digest = trace_digest(self.schedule)
        n = len(self.schedule)
        threads = [threading.Thread(target=self._worker_loop, args=(i,),
                                    daemon=True, name=f"lg-worker-{i}")
                   for i in range(self.workers)]
        pump_stop = threading.Event()
        pump_thread = None
        if self.pump is not None:
            def pump_loop():
                while not pump_stop.wait(0.02):
                    try:
                        self.pump()
                    except Exception:
                        continue
            pump_thread = threading.Thread(target=pump_loop, daemon=True)
            pump_thread.start()
        t0 = time.perf_counter()
        self._t0 = t0
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        duration = time.perf_counter() - t0
        if pump_thread is not None:
            pump_stop.set()
            pump_thread.join(timeout=5)
        return LoadReport(duration_s=duration, scheduled=n,
                          trace_digest=digest, stats=dict(self._stats),
                          registry=self.registry,
                          max_retry_after_s=self._max_retry_after)

    def abort(self) -> None:
        self._abort.set()

    def _worker_loop(self, worker_index: int) -> None:
        n = len(self.schedule)
        while not self._abort.is_set():
            with self._cursor_lock:
                idx = self._cursor
                if idx >= n:
                    return
                self._cursor = idx + 1
            op = self.schedule[idx]
            due = self._t0 + op.at_s
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            client = self.clients[idx % len(self.clients)]
            sent = time.perf_counter()
            ok, shed, busy, err = False, False, False, ""
            try:
                self._execute(client, op)
                ok = True
            except ServiceBusyError as exc:
                shed = True  # server admission door: quota rejection
                retry_after = float(getattr(exc, "retry_after_s", 0.0) or 0.0)
                with self._stats_lock:
                    self._max_retry_after = max(self._max_retry_after,
                                                retry_after)
            except ServiceBusy:
                busy = True  # client-side breaker: never reached a host
            except Exception as exc:
                err = type(exc).__name__
            done = time.perf_counter()
            self._record(op, latency=done - due, service=done - sent,
                         lag=sent - due, ok=ok, shed=shed, busy=busy,
                         err=err)

    # -- op execution ------------------------------------------------------

    def _execute(self, client, op: ScheduledOp) -> None:
        from ..core.events import RetryPolicy
        if op.kind == OP_START:
            client.start_workflow_execution(
                op.domain, op.workflow_id, CHURN_TYPE,
                churn_task_list(op.domain))
        elif op.kind == OP_CRON_START:
            # cron churn workflows recycle through the completers run
            # after run — the cron+retry storm surface
            client.start_workflow_execution(
                op.domain, op.workflow_id, CHURN_TYPE,
                churn_task_list(op.domain), cron_schedule="* * * * *")
        elif op.kind == OP_RETRY_START:
            client.start_workflow_execution(
                op.domain, op.workflow_id, CHURN_TYPE,
                churn_task_list(op.domain),
                retry_policy=RetryPolicy(initial_interval_seconds=1,
                                         backoff_coefficient=2.0,
                                         maximum_interval_seconds=10,
                                         maximum_attempts=3))
        elif op.kind == OP_SIGNAL:
            # request-id carries the schedule index: a client-side retry
            # of the same scheduled signal dedups server-side
            client.signal_workflow_execution(
                op.domain, op.workflow_id, op.arg,
                request_id=(f"lg-req-{self.request_salt}"
                            f"{op.domain}-{op.index}"))
        elif op.kind == OP_SIGNAL_WITH_START:
            client.signal_with_start_workflow_execution(
                op.domain, op.workflow_id, op.arg, POOL_TYPE,
                pool_task_list(op.domain))
        elif op.kind == OP_QUERY:
            # the mutable-state read API — the consistent-query transport
            # needs an answering worker, so load-shaped "queries" read
            # the authoritative state instead
            client.describe_workflow_execution(op.domain, op.workflow_id)
        elif op.kind == OP_LONGPOLL:
            client.get_workflow_execution_history(
                op.domain, op.workflow_id, wait_for_new_event=True,
                last_event_id=1_000_000, timeout=self.longpoll_timeout_s)
        elif op.kind == OP_RESET:
            # pool workflows keep a decision boundary at event 4 (seeded
            # in prepare; a reset forks BEFORE it, so the boundary
            # survives into every new run — resets are repeatable)
            client.reset_workflow_execution(
                op.domain, op.workflow_id, decision_finish_event_id=4,
                reason=f"loadgen-{op.index}")
        elif op.kind == OP_LIST:
            # arg carries the seeded visibility query (mixes.VIS_QUERIES)
            client.list_workflow_executions(op.domain, op.arg)
        elif op.kind == OP_SCAN:
            client.scan_workflow_executions(op.domain, op.arg)
        elif op.kind == OP_COUNT:
            client.count_workflow_executions(op.domain, op.arg)
        else:
            raise ValueError(f"unknown op kind {op.kind!r}")

    # -- recording ---------------------------------------------------------

    def _record(self, op: ScheduledOp, latency: float, service: float,
                lag: float, ok: bool, shed: bool, busy: bool,
                err: str) -> None:
        scope = f"{m.SCOPE_LOADGEN_PREFIX}.{op.kind}"
        r = self.registry
        r.record(scope, "latency", latency)
        r.record(scope, m.domain_metric("latency", op.domain), latency)
        r.record(scope, "service-latency", service)
        r.observe(scope, "dispatch-lag", max(lag, 0.0))
        with self._stats_lock:
            s = self._stats.setdefault((op.kind, op.domain), OpStats())
            s.sent += 1
            if ok:
                s.ok += 1
            elif shed:
                s.shed += 1
            elif busy:
                s.shed_busy += 1
            else:
                s.errors += 1
                s.error_types[err] = s.error_types.get(err, 0) + 1
        r.inc(scope, "sent")
        r.inc(scope, m.domain_metric("sent", op.domain))
        if ok:
            r.inc(scope, "ok")
        elif shed:
            r.inc(scope, m.M_QUOTA_SHED)
            r.inc(scope, m.domain_metric(m.M_QUOTA_SHED, op.domain))
        elif busy:
            r.inc(scope, "shed-busy")
            r.inc(scope, m.domain_metric("shed-busy", op.domain))
        else:
            r.inc(scope, "errors")
