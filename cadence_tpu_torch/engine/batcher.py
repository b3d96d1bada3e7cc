"""Batch operations worker: terminate/cancel/signal over a visibility query.

Reference: service/worker/batcher/batcher.go — a system workflow that
pages through a visibility query and applies one operation per execution
with rate-limited pacing (RPS knob) and per-execution error isolation,
reporting success/failure counts. Here the pager is the visibility
query engine (engine/visibility_query.py) and the pacing rides the
quotas tier (common/quotas analog).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Tuple

from ..utils.log import DEFAULT_LOGGER
from ..utils.quotas import ServiceBusyError, TokenBucket

OP_TERMINATE = "terminate"
OP_CANCEL = "cancel"
OP_SIGNAL = "signal"


@dataclass
class BatchReport:
    total: int = 0
    succeeded: int = 0
    #: (workflow_id, run_id, error) triples — per-execution isolation,
    #: never aborting the batch (batcher.go continues past failures)
    failures: List[Tuple[str, str, str]] = field(default_factory=list)

    @property
    def failed(self) -> int:
        return len(self.failures)


class Batcher:
    #: per-record retry budget against quota sheds before the record is
    #: reported failed (quota refills between attempts; only a quota far
    #: below the batch's demand exhausts it)
    SHED_RETRIES = 8

    def __init__(self, frontend, rps: float = 50.0, logger=None) -> None:
        self.frontend = frontend
        self.rps = rps
        self.log = (logger or DEFAULT_LOGGER).with_tags(component="batcher")

    def run(self, domain: str, query: str, operation: str,
            reason: str = "batch operation", signal_name: str = "") -> BatchReport:
        """One batch job (batcher.go BatchWorkflow): resolve the query,
        pace at `rps`, apply the operation to every OPEN match."""
        if operation not in (OP_TERMINATE, OP_CANCEL, OP_SIGNAL):
            raise ValueError(f"unknown batch operation {operation!r}")
        if operation == OP_SIGNAL and not signal_name:
            raise ValueError("signal batch needs a signal name")
        # pacing rides its OWN wall clock (batcher.go RPS is a real-world
        # rate): advancing the cluster's logical clock to pace ourselves
        # would fire unrelated timers as a side effect
        from ..utils.clock import RealTimeSource
        limiter = TokenBucket(RealTimeSource(), rps=self.rps,
                              burst=max(1.0, self.rps))
        report = BatchReport()
        targets = [r for r in self.frontend.list_workflow_executions(
            domain, query) if r.close_status == -1]
        report.total = len(targets)
        self.log.info("batch starting", domain=domain, op=operation,
                      query=query, targets=report.total)
        for rec in targets:
            while not limiter.allow():
                time.sleep(1.0 / max(self.rps, 1.0))
            try:
                for attempt in range(self.SHED_RETRIES):
                    try:
                        if operation == OP_TERMINATE:
                            self.frontend.terminate_workflow_execution(
                                domain, rec.workflow_id, run_id=rec.run_id,
                                reason=reason)
                        elif operation == OP_CANCEL:
                            self.frontend.request_cancel_workflow_execution(
                                domain, rec.workflow_id, run_id=rec.run_id)
                        else:
                            self.frontend.signal_workflow_execution(
                                domain, rec.workflow_id, signal_name,
                                run_id=rec.run_id)
                        break
                    except ServiceBusyError as exc:
                        # the domain quota shedding a batch op is
                        # BACKPRESSURE, not a per-record failure: honor
                        # the retry-after hint and try the same record
                        # again (bounded, so a near-zero quota still
                        # surfaces as failures instead of a hung batch)
                        if attempt == self.SHED_RETRIES - 1:
                            raise
                        time.sleep(max(float(exc.retry_after_s or 0.0),
                                       1.0 / max(self.rps, 1.0)))
                report.succeeded += 1
            except Exception as exc:  # per-execution isolation
                report.failures.append((rec.workflow_id, rec.run_id,
                                        str(exc)))
        self.log.info("batch finished", domain=domain, op=operation,
                      succeeded=report.succeeded, failed=report.failed)
        return report
