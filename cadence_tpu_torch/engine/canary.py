"""Continuous canary: a self-verifying feature suite against a LIVE cluster.

Reference: canary/ — a cron workflow (cron.go:41) fans out one child per
feature (sanity.go:28-46: echo, signal, timer, query, visibility, batch,
reset, concurrent child, retry activity, ...), each asserting its own
end-to-end behavior through the public frontend; green cycles are the
cluster's liveness proof. Here the same structure is an explicit runner:
each cycle executes every feature through frontend APIs only (so it runs
identically against an in-process Onebox or a wire cluster's
FrontendClient), polls decisions like a real worker, and verifies the
outcome — per-feature isolation, failures reported not raised.
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List

from ..core.enums import CloseStatus, DecisionType, EventType
from ..utils.log import DEFAULT_LOGGER


@dataclass
class CycleResult:
    cycle: int
    passed: List[str] = field(default_factory=list)
    failed: Dict[str, str] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.failed


@dataclass
class CanaryReport:
    cycles: List[CycleResult] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.cycles)

    @property
    def green_cycles(self) -> int:
        return sum(1 for c in self.cycles if c.ok)

    def summary(self) -> dict:
        failures: Dict[str, int] = {}
        for c in self.cycles:
            for feat in c.failed:
                failures[feat] = failures.get(feat, 0) + 1
        return {"cycles": len(self.cycles), "green": self.green_cycles,
                "failures_by_feature": failures, "ok": self.ok}


class Canary:
    """One canary instance bound to a frontend + domain (canary/canary.go).

    `pump` is an optional zero-arg callable that advances an in-process
    cluster's queues (Onebox.pump_once); wire clusters pump themselves,
    so the default no-op just yields."""

    FEATURES = ("echo", "signal", "timer", "query", "visibility",
                "batch", "reset")

    def __init__(self, frontend, domain: str, task_list: str = "canary-tl",
                 pump=None, poll_wait: float = 0.2,
                 deadline_s: float = 15.0) -> None:
        self.frontend = frontend
        self.domain = domain
        self.task_list = task_list
        self.pump = pump if pump is not None else (lambda: None)
        self.poll_wait = poll_wait
        self.deadline_s = deadline_s
        self.log = DEFAULT_LOGGER.with_tags(component="canary")

    # -- worker loop -------------------------------------------------------

    def _drive(self, deciders: Dict[str, object],
               want_closed: List[str]) -> None:
        """Poll decisions for the cycle's workflows until the watched set
        closes (host/taskpoller.go, frontend-only)."""
        deadline = time.monotonic() + self.deadline_s
        remaining = set(want_closed)
        while remaining and time.monotonic() < deadline:
            self.pump()
            # activities complete unconditionally (the canary's activity
            # bodies are echoes)
            act = self.frontend.poll_for_activity_task(
                self.domain, self.task_list, wait_seconds=0)
            if act is not None and act.token is not None:
                self.frontend.respond_activity_task_completed(act.token)
            resp = self.frontend.poll_for_decision_task(
                self.domain, self.task_list, wait_seconds=self.poll_wait)
            if resp is None or resp.token is None:
                for wf in list(remaining):
                    if self._closed(wf):
                        remaining.discard(wf)
                continue
            decider = deciders.get(resp.token.workflow_id)
            decisions = decider.decide(resp.history) if decider else []
            try:
                self.frontend.respond_decision_task_completed(resp.token,
                                                              decisions)
            except Exception:
                continue  # stale token after a reset/terminate race
            if self._closed(resp.token.workflow_id):
                remaining.discard(resp.token.workflow_id)
        if remaining:
            raise TimeoutError(f"workflows never closed: {sorted(remaining)}")

    def _closed(self, workflow_id: str) -> bool:
        try:
            ms = self.frontend.describe_workflow_execution(self.domain,
                                                           workflow_id)
            return ms.execution_info.close_status != CloseStatus.Nothing
        except Exception:
            return False

    # -- features (sanity.go's list) --------------------------------------

    def _echo(self, tag: str) -> None:
        from ..models.deciders import EchoDecider
        wf = f"canary-echo-{tag}"
        self.frontend.start_workflow_execution(self.domain, wf, "canary-echo",
                                               self.task_list)
        self._drive({wf: EchoDecider(self.task_list)}, [wf])
        self._require_completed(wf)

    def _signal(self, tag: str) -> None:
        from ..models.deciders import SignalDecider
        wf = f"canary-signal-{tag}"
        self.frontend.start_workflow_execution(self.domain, wf,
                                               "canary-signal",
                                               self.task_list)
        for i in range(2):
            self.frontend.signal_workflow_execution(self.domain, wf,
                                                    f"canary-{i}")
        self._drive({wf: SignalDecider(expected_signals=2)}, [wf])
        self._require_completed(wf)

    def _timer(self, tag: str) -> None:
        from ..models.deciders import TimerDecider
        wf = f"canary-timer-{tag}"
        self.frontend.start_workflow_execution(self.domain, wf, "canary-timer",
                                               self.task_list)
        # 1s: fires via the real timer queue on wire clusters; in-process
        # harnesses advance their manual clock through the pump hook
        self._drive({wf: TimerDecider(fire_seconds=1)}, [wf])
        self._require_completed(wf)

    def _query(self, tag: str) -> None:
        """QueryWorkflow end-to-end: idle the workflow, query it, answer
        the query task, read the result, then close (canary query.go)."""
        wf = f"canary-query-{tag}"
        self.frontend.start_workflow_execution(self.domain, wf, "canary-query",
                                               self.task_list)
        # first decision: respond empty so the workflow idles
        deadline = time.monotonic() + self.deadline_s
        idled = False
        while not idled and time.monotonic() < deadline:
            self.pump()
            resp = self.frontend.poll_for_decision_task(
                self.domain, self.task_list, wait_seconds=self.poll_wait)
            if resp is None or resp.token is None:
                continue
            self.frontend.respond_decision_task_completed(resp.token, [])
            idled = resp.token.workflow_id == wf
        if not idled:
            raise TimeoutError("query canary never idled")
        qid = self.frontend.query_workflow(self.domain, wf, "canary-q")
        answered = False
        deadline = time.monotonic() + self.deadline_s
        while not answered and time.monotonic() < deadline:
            self.pump()
            resp = self.frontend.poll_for_decision_task(
                self.domain, self.task_list, wait_seconds=self.poll_wait)
            if resp is None:
                continue
            if getattr(resp, "query_only", False):
                for q_id, _qt, _args in resp.queries:
                    self.frontend.respond_query_task_completed(
                        resp.execution, q_id, b"canary-state")
                    answered = answered or q_id == qid
            elif resp.token is not None:
                results = {q_id: b"canary-state"
                           for q_id, _qt, _args in resp.queries}
                self.frontend.respond_decision_task_completed(
                    resp.token, [], query_results=results)
                answered = qid in results
        _state, result, failure = self.frontend.get_query_result(
            self.domain, wf, qid)
        if failure or result != b"canary-state":
            raise RuntimeError(f"query result {result!r} failure {failure!r}")
        # close it out
        from ..models.deciders import SignalDecider
        self.frontend.signal_workflow_execution(self.domain, wf, "done")
        self._drive({wf: SignalDecider(expected_signals=1)}, [wf])
        self._require_completed(wf)

    def _visibility(self, tag: str) -> None:
        """The echo workflow this cycle completed must be FINDABLE by a
        filtered visibility query (the ES-canary analog)."""
        wf = f"canary-echo-{tag}"
        deadline = time.monotonic() + self.deadline_s
        while time.monotonic() < deadline:
            self.pump()
            hits = self.frontend.list_workflow_executions(
                self.domain,
                "WorkflowType = 'canary-echo' AND CloseStatus = 'Completed'")
            if wf in [r.workflow_id for r in hits]:
                return
            time.sleep(0.05)
        raise TimeoutError(f"{wf} never appeared in visibility")

    def _batch(self, tag: str) -> None:
        """Batch-signal open canary workflows, then complete them."""
        from ..engine.batcher import Batcher
        from ..models.deciders import SignalDecider
        wfs = [f"canary-batch-{tag}-{i}" for i in range(2)]
        for wf in wfs:
            self.frontend.start_workflow_execution(self.domain, wf,
                                                   "canary-batch",
                                                   self.task_list)
        # visibility trails the async start task: wait until both targets
        # are listable, or the batch would resolve to zero targets
        deadline = time.monotonic() + self.deadline_s
        while time.monotonic() < deadline:
            self.pump()
            open_ids = {r.workflow_id for r in
                        self.frontend.list_workflow_executions(
                            self.domain, "WorkflowType = 'canary-batch'")
                        if r.close_status == -1}
            if set(wfs) <= open_ids:
                break
            time.sleep(0.05)
        report = Batcher(self.frontend, rps=100).run(
            self.domain, "WorkflowType = 'canary-batch'",
            "signal", signal_name="batch-go")
        if report.failed:
            raise RuntimeError(f"batch failures: {report.failures}")
        self._drive({wf: SignalDecider(expected_signals=1) for wf in wfs},
                    wfs)
        for wf in wfs:
            self._require_completed(wf)

    def _reset(self, tag: str) -> None:
        """Reset a workflow past its first decision, then the NEW run
        completes (the reset-canary, canary/reset.go)."""
        from ..models.deciders import SignalDecider
        wf = f"canary-reset-{tag}"
        self.frontend.start_workflow_execution(self.domain, wf,
                                               "canary-reset",
                                               self.task_list)
        self.frontend.signal_workflow_execution(self.domain, wf, "pre")
        # complete the first decision so a completed decision exists
        deadline = time.monotonic() + self.deadline_s
        first_done = False
        while not first_done and time.monotonic() < deadline:
            self.pump()
            resp = self.frontend.poll_for_decision_task(
                self.domain, self.task_list, wait_seconds=self.poll_wait)
            if resp is None or resp.token is None:
                continue
            self.frontend.respond_decision_task_completed(resp.token, [])
            first_done = resp.token.workflow_id == wf
        if not first_done:
            raise TimeoutError("first decision never completed before reset")
        events = self.frontend.get_workflow_execution_history(self.domain, wf)
        finish_id = max(e.id for e in events
                        if e.event_type == EventType.DecisionTaskCompleted)
        new_run = self.frontend.reset_workflow_execution(
            self.domain, wf, decision_finish_event_id=finish_id,
            reason=f"canary-{tag}")
        self.frontend.signal_workflow_execution(self.domain, wf, "post")
        self._drive({wf: SignalDecider(expected_signals=2)}, [wf])
        ms = self.frontend.describe_workflow_execution(self.domain, wf)
        if ms.execution_info.run_id != new_run:
            raise RuntimeError("current run is not the reset run")
        self._require_completed(wf)

    def _require_completed(self, workflow_id: str) -> None:
        ms = self.frontend.describe_workflow_execution(self.domain,
                                                       workflow_id)
        status = ms.execution_info.close_status
        if status != CloseStatus.Completed:
            raise RuntimeError(
                f"{workflow_id}: close_status {CloseStatus(status).name}")

    # -- cycles ------------------------------------------------------------

    def run_cycle(self, cycle: int) -> CycleResult:
        tag = f"{cycle}-{uuid.uuid4().hex[:6]}"
        result = CycleResult(cycle=cycle)
        for feature in self.FEATURES:
            try:
                getattr(self, f"_{feature}")(tag)
                result.passed.append(feature)
            except Exception as exc:  # per-feature isolation (sanity.go)
                result.failed[feature] = f"{type(exc).__name__}: {exc}"
                self.log.error("canary feature failed", feature=feature,
                               cycle=cycle, error=str(exc))
        return result

    def run(self, cycles: int, interval_s: float = 0.0) -> CanaryReport:
        """The cron loop (cron.go:41): `cycles` rounds, every feature
        each round; the report aggregates green cycles per feature."""
        report = CanaryReport()
        for i in range(cycles):
            report.cycles.append(self.run_cycle(i))
            if interval_s:
                time.sleep(interval_s)
        return report
