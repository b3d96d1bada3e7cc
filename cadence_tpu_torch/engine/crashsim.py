"""CrashSim: the kill-anywhere WAL cut-point matrix.

The strongest crash-consistency claim this framework can make is that for
ANY prefix of the write-ahead log — the process may die between any two
record writes, or mid-record — full recovery yields a state the fault-free
execution actually passed through. CrashSim proves it exhaustively for a
recorded workload:

1. **baseline** replays the fault-free log once, recording for every run
   the SEQUENCE of mutable-state checksums after each history-affecting
   record (via a scratch HistoryStore, so append/overwrite/fork semantics
   match recovery exactly) — the set of legal prefix states;
2. **sweep** truncates the log at EVERY record boundary (and, on the JSONL
   backend, additionally leaves a torn mid-record tail at every boundary —
   SQLite commits atomically, so it has no torn-tail case), runs full
   recovery at each cut, and asserts:

   - every recovered run is a run the fault-free log knows;
   - every recovered run's checksum is byte-identical to one of that
     run's legal prefix checksums (prefix consistency: a crash can lose
     the tail of history, never corrupt or reorder it);
   - the recovery fsck (engine/walcheck.py) reports zero findings;
   - the task refresher regenerates work for exactly the current runs —
     at least one task per current run, none for quarantined ones.

Both open_log backends run the same matrix; the per-cut state is recovered
with the ORACLE rebuilder (`rebuild_on_device=False`) so the sweep is pure
host work — the TPU bulk-verify path has its own parity suite.

The Oneboxes built here (the seeded workload's, and the one each cut's
refresh check wires over the recovered stores) take the `device` the
caller names: None means the card, and without one construction raises.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..core.checksum import Checksum
from ..oracle.mutable_state import MutableState
from ..oracle.state_builder import StateBuilder
from . import walcheck
from .durability import (
    SqliteLog,
    is_sqlite_path,
    migrate_records,
    recover_stores,
)
from .persistence import EntityNotExistsError, HistoryStore

RunKey = Tuple[str, str, str]


@dataclass
class CutResult:
    """One recovery at one cut point."""

    cut: int                 # records kept (prefix length)
    torn: bool = False       # a torn mid-record tail follows the prefix
    recovered_runs: int = 0
    open_workflows: int = 0
    quarantined: int = 0
    refreshed_tasks: int = 0
    errors: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


@dataclass
class CrashSimReport:
    wal: str
    backend: str
    records: int = 0
    cuts: List[CutResult] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.cuts)

    @property
    def failures(self) -> List[CutResult]:
        return [c for c in self.cuts if not c.ok]

    def summary(self) -> dict:
        return {
            "wal": self.wal, "backend": self.backend, "ok": self.ok,
            "records": self.records, "cuts": len(self.cuts),
            "torn_cuts": sum(1 for c in self.cuts if c.torn),
            "failures": [
                {"cut": c.cut, "torn": c.torn, "errors": c.errors}
                for c in self.failures][:20],
        }


class CrashSim:
    """Cut-point sweep over one recorded WAL."""

    def __init__(self, wal_path: str, workdir: Optional[str] = None,
                 device=None) -> None:
        self.wal_path = wal_path
        #: the device of the refresh check's Onebox (None = the card)
        self.device = device
        self.backend = "sqlite" if is_sqlite_path(wal_path) else "jsonl"
        self.workdir = workdir or (os.path.dirname(
            os.path.abspath(wal_path)) or ".")
        self.raw_lines = walcheck.read_raw_lines(wal_path)

    # -- baseline ----------------------------------------------------------

    def baseline(self) -> Dict[RunKey, Set[int]]:
        """Legal prefix checksums per run, from the fault-free log.

        Replays only the history-shaping records (h/f/cb/delw) through a
        scratch HistoryStore — the exact store recovery replays into — and
        after each one recomputes the affected run's checksum by oracle
        replay of its CURRENT branch. The resulting per-run sets are every
        state the fault-free run ever committed."""
        records, _ = migrate_records(
            [json.loads(l) for l in self.raw_lines if _parses(l)])
        scratch = HistoryStore()
        legal: Dict[RunKey, Set[int]] = {}
        for rec in records:
            t = rec.get("t")
            if t not in ("h", "f", "cb", "delw"):
                continue
            key: RunKey = (rec["d"], rec["w"], rec["r"])
            if t == "h":
                import base64
                from ..core.codec import deserialize_history
                for batch in deserialize_history(
                        base64.b64decode(rec["blob"]), *key):
                    scratch.append_batch(*key, events=batch.events,
                                         branch=rec["b"])
            elif t == "f":
                scratch.fork_branch(*key, source_branch=rec["src"],
                                    fork_event_id=rec["at"])
            elif t == "cb":
                scratch.set_current_branch(*key, branch=rec["b"])
            elif t == "delw":
                scratch.delete_run(*key)
                continue
            legal.setdefault(key, set()).add(self._replay_checksum(
                scratch, key))
        return legal

    @staticmethod
    def _replay_checksum(store: HistoryStore, key: RunKey) -> int:
        branch = store.get_current_branch(*key)
        sb = StateBuilder(MutableState())
        for batch in store.as_history_batches(*key, branch=branch):
            sb.apply_batch(batch)
        return Checksum.of(sb.ms).value

    # -- cut materialization ----------------------------------------------

    def _scratch_path(self) -> str:
        return os.path.join(
            self.workdir,
            f"_crashsim_cut.{'db' if self.backend == 'sqlite' else 'jsonl'}")

    def _materialize(self, cut: int, torn: bool) -> str:
        """Write the first `cut` raw records (plus, when `torn`, a partial
        copy of record `cut`) to a scratch log of the same backend."""
        path = self._scratch_path()
        if os.path.exists(path):
            os.remove(path)
        prefix = self.raw_lines[:cut]
        if self.backend == "sqlite":
            # raw bodies preserved verbatim (no parse→re-dump drift)
            import sqlite3
            conn = sqlite3.connect(path)
            try:
                conn.execute("CREATE TABLE records (id INTEGER PRIMARY KEY "
                             "AUTOINCREMENT, body TEXT NOT NULL)")
                conn.executemany("INSERT INTO records(body) VALUES (?)",
                                 [(l,) for l in prefix])
                conn.commit()
            finally:
                conn.close()
            return path
        with open(path, "w", encoding="utf-8") as fh:
            for line in prefix:
                fh.write(line + "\n")
            if torn and cut < len(self.raw_lines):
                nxt = self.raw_lines[cut]
                fh.write(nxt[: max(1, len(nxt) // 2)])  # no newline
        return path

    # -- the sweep ---------------------------------------------------------

    def run(self, torn: bool = True, stride: int = 1,
            legal: Optional[Dict[RunKey, Set[int]]] = None
            ) -> CrashSimReport:
        """Recover at every `stride`-th record boundary (always including
        the full log) and check the invariants; on JSONL additionally at
        every torn mid-record tail."""
        report = CrashSimReport(wal=self.wal_path, backend=self.backend,
                                records=len(self.raw_lines))
        legal = self.baseline() if legal is None else legal
        n = len(self.raw_lines)
        cuts = sorted(set(list(range(0, n, max(1, stride))) + [n]))
        try:
            for cut in cuts:
                report.cuts.append(self._one_cut(cut, False, legal))
                if torn and self.backend == "jsonl" and cut < n:
                    report.cuts.append(self._one_cut(cut, True, legal))
        finally:
            # never leave the scratch log beside a real WAL — it looks
            # exactly like one to directory-scanning tooling
            scratch = self._scratch_path()
            if os.path.exists(scratch):
                os.remove(scratch)
        return report

    def _one_cut(self, cut: int, torn: bool,
                 legal: Dict[RunKey, Set[int]]) -> CutResult:
        result = CutResult(cut=cut, torn=torn)
        path = self._materialize(cut, torn)
        try:
            stores, recovery = recover_stores(path, verify_on_device=False,
                                              rebuild_on_device=False)
        except Exception as exc:
            result.errors.append(f"recovery raised {type(exc).__name__}: "
                                 f"{exc}")
            return result
        result.open_workflows = recovery.open_workflows
        result.quarantined = len(recovery.quarantined)
        if recovery.divergent:
            result.errors.append(f"divergent states: {recovery.divergent}")

        # prefix consistency: recovered runs ⊆ fault-free runs, and each
        # recovered checksum is byte-identical to a legal prefix state
        for key in stores.execution.list_executions():
            result.recovered_runs += 1
            try:
                ms = stores.execution.get_workflow(*key)
            except EntityNotExistsError:
                continue
            if key not in legal:
                result.errors.append(f"run {key} recovered but never "
                                     "committed by the fault-free log")
                continue
            value = Checksum.of(ms).value
            if value not in legal[key]:
                result.errors.append(
                    f"run {key}: recovered checksum {value} is not any "
                    f"fault-free prefix state ({len(legal[key])} legal)")

        # recovery fsck: zero findings at every cut
        findings = (walcheck.audit_records(walcheck.read_raw_lines(path))
                    + walcheck.audit_stores(stores))
        for finding in findings:
            result.errors.append(f"fsck: {finding.code} "
                                 f"[{finding.subject}] {finding.detail}")

        # the task refresher regenerates work for exactly the current runs
        result.refreshed_tasks = self._check_refresh(stores, result)
        return result

    def _check_refresh(self, stores, result: CutResult) -> int:
        from .onebox import Onebox
        box = Onebox(num_hosts=1, num_shards=4, stores=stores,
                     device=self.device)
        total = 0
        for key in stores.execution.list_executions():
            domain_id, workflow_id, run_id = key
            try:
                is_current = (stores.execution.get_current_run_id(
                    domain_id, workflow_id) == run_id)
            except EntityNotExistsError:
                is_current = False
            if not is_current:
                continue  # quarantined/zombie runs are never refreshed
            created = box.route(workflow_id).refresh_tasks(
                domain_id, workflow_id, run_id)
            total += created
            if created < 1:
                result.errors.append(
                    f"refresher created no tasks for current run {key}")
        return total


def _parses(line: str) -> bool:
    try:
        json.loads(line)
        return True
    except Exception:
        return False


# -- seeded workload --------------------------------------------------------


def seed_workload(wal_path: str, num_workflows: int = 4, device=None) -> None:
    """Record a small deterministic mixed workload into `wal_path`: echo
    workflows driven to completion, open workflows parked with a pending
    activity + user timer, request-id-deduped signals, and queue traffic
    including a purge — every WAL record type the crash matrix should cut
    through (shared by the crash tests, the `wal crashsim
    --seed-workload` verb, and deploy/smoke_crash.sh)."""
    from ..core.enums import DecisionType
    from .durability import open_durable_stores
    from .history_engine import Decision
    from .onebox import Onebox

    domain, task_list = "crash-domain", "crash-tl"
    box = Onebox(num_hosts=1, num_shards=4,
                 stores=open_durable_stores(wal_path), device=device)
    box.frontend.register_domain(domain)

    def decide(workflow_id: str, decisions: List) -> None:
        for _ in range(50):
            resp = box.frontend.poll_for_decision_task(domain, task_list)
            if resp is None:
                box.pump_once()
                continue
            if resp.token.workflow_id != workflow_id:
                box.frontend.respond_decision_task_completed(resp.token, [])
                continue
            box.frontend.respond_decision_task_completed(resp.token,
                                                         decisions)
            return
        raise RuntimeError(f"no decision task for {workflow_id}")

    def run_activity() -> None:
        for _ in range(50):
            resp = box.frontend.poll_for_activity_task(domain, task_list)
            if resp is not None:
                box.frontend.respond_activity_task_completed(resp.token)
                return
            box.pump_once()
        raise RuntimeError("no activity task")

    activity = Decision(DecisionType.ScheduleActivityTask, dict(
        activity_id="a-0", task_list=task_list,
        schedule_to_start_timeout_seconds=60,
        schedule_to_close_timeout_seconds=120,
        start_to_close_timeout_seconds=60, heartbeat_timeout_seconds=0))
    timer = Decision(DecisionType.StartTimer, dict(
        timer_id="t-0", start_to_fire_timeout_seconds=600))
    complete = Decision(DecisionType.CompleteWorkflowExecution)

    half = max(1, num_workflows // 2)
    for i in range(half):  # completed echoes
        workflow_id = f"crash-echo-{i}"
        box.frontend.start_workflow_execution(domain, workflow_id, "echo",
                                              task_list)
        box.pump_once()
        decide(workflow_id, [activity])
        box.pump_once()
        run_activity()
        box.pump_once()
        decide(workflow_id, [complete])
        box.pump_once()
    for i in range(num_workflows - half):  # parked open workflows
        workflow_id = f"crash-open-{i}"
        box.frontend.start_workflow_execution(domain, workflow_id, "open",
                                              task_list)
        box.pump_once()
        decide(workflow_id, [activity, timer])
        box.pump_once()

    # request-id signal legs: the duplicate must be a WAL-visible no-op
    target = "crash-open-0" if num_workflows - half else "crash-echo-0"
    if num_workflows - half:
        box.frontend.signal_workflow_execution(domain, target, "go",
                                               request_id="rid-1")
        box.frontend.signal_workflow_execution(domain, target, "go",
                                               request_id="rid-1")
        box.frontend.signal_workflow_execution(domain, target, "again",
                                               request_id="rid-2")
        box.pump_once()

    # queue traffic: enqueue + consumer ack + a purge cycle (qp record)
    from .domainrepl import DomainReplicationTask
    info = box.frontend.describe_domain(domain)
    task = DomainReplicationTask(
        domain_id=info.domain_id, name=info.name,
        retention_days=info.retention_days,
        active_cluster=info.active_cluster, clusters=tuple(info.clusters),
        failover_version=info.failover_version,
        notification_version=info.notification_version, status=info.status,
        description=info.description,
        history_archival_uri=info.history_archival_uri)
    for _ in range(3):
        box.stores.queue.enqueue("domainrepl", task)
    box.stores.queue.set_ack("domainrepl", "standby", 1)
    box.stores.queue.enqueue("crash-dlq", task)
    box.stores.queue.set_ack("crash-dlq", "standby", 0)
    box.stores.queue.purge("crash-dlq")
    box.stores.queue.enqueue("crash-dlq", task)
    box.stores.wal.close()
