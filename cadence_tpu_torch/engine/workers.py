"""System workers: retention scavenger + execution scanner.

Reference: service/worker/ — background system workflows running against
the cluster itself. Implemented here as explicit passes a host loop (or a
test) drives:

- **RetentionScavenger** (service/worker/scanner history scavenger): the
  backstop for lost DeleteHistoryEvent timers — sweeps closed runs whose
  retention elapsed (by visibility close time + domain retention) and
  deletes them through the owning engine;
- **ExecutionScanner** (service/worker/scanner executions scanner over
  common/reconciliation/invariant): checks concrete-execution invariants —
  every current pointer resolves to a persisted run, every persisted run
  has history — and runs the device bulk verify (verify_all) as the
  mutable-state invariant; `fix=True` drops orphaned current pointers
  (the concreteExecutionExists fixer).

Parent-close-policy fan-out lives on the close path itself
(queues._apply_parent_close_policy — the reference routes it through a
parentclosepolicy system workflow for scale; same semantic).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from .persistence import EntityNotExistsError, Stores

_DAY_NANOS = 24 * 3600 * 1_000_000_000


class RetentionScavenger:
    """Sweep closed runs past retention (scanner/history scavenger)."""

    def __init__(self, stores: Stores, router, time_source, metrics=None) -> None:
        from ..utils.metrics import DEFAULT_REGISTRY
        self.stores = stores
        self.router = router
        self.clock = time_source
        self.metrics = metrics if metrics is not None else DEFAULT_REGISTRY

    def run_once(self) -> int:
        """Delete every closed run whose close time + domain retention is
        past; returns how many runs were deleted. Domains with an archival
        URI ARCHIVE history (and the closed-visibility record) BEFORE the
        delete (service/worker/archiver pump → common/archiver.Archive);
        an archive failure SKIPS the delete — retention never destroys the
        only copy (archive-then-delete ordering)."""
        from dataclasses import asdict

        from .archival import archiver_for

        now = self.clock.now()
        deleted = 0
        archived = 0
        for rec in self.stores.visibility.all_closed():
            try:
                domain = self.stores.domain.by_id(rec.domain_id)
                retention_days = domain.retention_days
                archival_uri = domain.history_archival_uri
            except EntityNotExistsError:
                retention_days, archival_uri = 1, ""
            if rec.close_time + retention_days * _DAY_NANOS > now:
                continue
            archiver = archiver_for(archival_uri)
            if archiver is not None:
                try:
                    batches = self.stores.history.as_history_batches(
                        rec.domain_id, rec.workflow_id, rec.run_id)
                    archiver.archive(rec.domain_id, rec.workflow_id,
                                     rec.run_id, batches,
                                     visibility=asdict(rec))
                    archived += 1
                except EntityNotExistsError:
                    pass  # history already gone; nothing to preserve
                except Exception:
                    # archive failed (I/O, serialization): keep THIS run
                    # and retry next pass — one bad record must not halt
                    # retention for every other domain
                    continue
            engine = self.router(rec.workflow_id)
            if engine.delete_workflow_execution(rec.domain_id,
                                                rec.workflow_id, rec.run_id):
                deleted += 1
        from ..utils import metrics as m
        self.metrics.inc(m.SCOPE_WORKER_SCAVENGER, m.M_RUNS_DELETED, deleted)
        self.metrics.inc(m.SCOPE_WORKER_SCAVENGER, m.M_RUNS_ARCHIVED, archived)
        return deleted


@dataclass
class ScanReport:
    """common/reconciliation invariant results."""

    executions: int = 0
    orphan_pointers: List[Tuple[str, str, str]] = field(default_factory=list)
    missing_history: List[Tuple[str, str, str]] = field(default_factory=list)
    state_divergent: List[Tuple[str, str, str]] = field(default_factory=list)
    #: OPEN runs holding no current pointer (invariant/openCurrentExecution
    #: .go): zombies are expected on a standby, orphans are not — both
    #: reported, neither dispatched
    open_without_pointer: List[Tuple[str, str, str]] = field(
        default_factory=list)
    #: pending activities/timers whose deadline math is inconsistent
    #: (invariant/timerInvalid.go analog): schedule ids beyond the
    #: history's next-event-id can never resolve
    invalid_pending: List[Tuple[str, str, str]] = field(default_factory=list)
    fixed: int = 0
    #: the device bulk-verify result backing state_divergent (one pass,
    #: shared with the watchdog rollup)
    verify: object = None

    @property
    def ok(self) -> bool:
        return not (self.orphan_pointers or self.missing_history
                    or self.state_divergent or self.invalid_pending)


class ExecutionScanner:
    """Concrete-execution invariants + device bulk verify."""

    def __init__(self, stores: Stores, tpu, metrics=None) -> None:
        from ..utils.metrics import DEFAULT_REGISTRY
        self.stores = stores
        self.tpu = tpu
        self.metrics = metrics if metrics is not None else DEFAULT_REGISTRY

    def run_once(self, fix: bool = False) -> ScanReport:
        report = ScanReport()
        # invariant: current pointer → persisted run
        # (invariant/openCurrentExecution.go / concreteExecutionExists.go)
        for (domain_id, workflow_id), cur in \
                self.stores.execution.list_current_pointers():
            try:
                self.stores.execution.get_workflow(domain_id, workflow_id,
                                                   cur.run_id)
            except EntityNotExistsError:
                report.orphan_pointers.append(
                    (domain_id, workflow_id, cur.run_id))
                if fix:
                    self.stores.execution.drop_current(domain_id, workflow_id)
                    report.fixed += 1
        # invariant: every persisted run has history
        # (invariant/historyExists.go)
        keys = self.stores.execution.list_executions()
        report.executions = len(keys)
        with_history = []
        for key in keys:
            if self.stores.history.branch_count(*key) == 0:
                report.missing_history.append(key)
            else:
                with_history.append(key)
        # per-key invariants off ONE state fetch: open run ⇒ current
        # pointer (openCurrentExecution.go; zombies visible, never
        # silently resident) and pending items reference events that
        # exist (timerInvalid.go analog — an entry past the history tail
        # can never resolve)
        from ..core.enums import WorkflowState
        for key in keys:
            ms = self.stores.execution.get_workflow(*key)
            info = ms.execution_info
            if info.state != WorkflowState.Completed:
                try:
                    is_current = (self.stores.execution.get_current_run_id(
                        key[0], key[1]) == key[2])
                except EntityNotExistsError:
                    is_current = False
                if not is_current:
                    report.open_without_pointer.append(key)
            next_id = info.next_event_id
            bad = any(sched >= next_id
                      for sched in ms.pending_activity_info_ids)
            bad = bad or any(ti.started_id >= next_id
                             for ti in ms.pending_timer_info_ids.values())
            if bad:
                report.invalid_pending.append(key)
        # invariant: mutable state replays bit-exact on device (the
        # checksum oracle as a scanner invariant, execution/checksum.go);
        # the result rides the report so callers (watchdog) never pay a
        # second full device pass
        if with_history:
            result = self.tpu.verify_all(with_history)
            report.state_divergent = list(result.divergent)
            report.verify = result
        from ..utils import metrics as m
        self.metrics.inc(m.SCOPE_WORKER_SCANNER, m.M_EXECUTIONS_SCANNED,
                         report.executions)
        self.metrics.inc(m.SCOPE_WORKER_SCANNER, m.M_INVARIANT_VIOLATIONS,
                         len(report.orphan_pointers)
                         + len(report.missing_history)
                         + len(report.state_divergent)
                         + len(report.invalid_pending))
        return report


class Watchdog:
    """Periodic health sweep (service/worker/watchdog + esanalyzer's
    corrective role, folded onto this framework's invariant surface):
    one pass = scanner invariants + device verification + retention
    scavenge, rolled into a single report the operator (or a cron'd CLI)
    can alert on."""

    def __init__(self, box) -> None:
        self.box = box

    def run_once(self, fix: bool = False) -> dict:
        scan = self.box.scanner.run_once(fix=fix)
        deleted = self.box.scavenger.run_once()
        verified = (scan.verify.verified_on_device
                    if scan.verify is not None else 0)
        report = {
            "ok": scan.ok,
            "executions": scan.executions,
            "orphan_pointers": len(scan.orphan_pointers),
            "missing_history": len(scan.missing_history),
            "state_divergent": len(scan.state_divergent),
            "open_without_pointer": len(scan.open_without_pointer),
            "invalid_pending": len(scan.invalid_pending),
            "verified_on_device": verified,
            "scavenged": deleted,
            "fixed": scan.fixed,
        }
        from ..utils.log import DEFAULT_LOGGER
        (DEFAULT_LOGGER.info if report["ok"] else DEFAULT_LOGGER.error)(
            "watchdog sweep", component="watchdog", **report)
        return report
