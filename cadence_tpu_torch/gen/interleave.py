"""Interleaving fuzzer: seeded live-transaction schedules under chaos.

The history fuzzer (gen/fuzz.py) proves the replay kernel over
arbitrary *persisted* histories; this module fuzzes what produces them
— the serving tier's live transaction stream. A seeded schedule of
frontend operations (start / signal with request-id dedup races /
signal-with-start start-vs-signal races / cancel / terminate / reset /
query / decision & activity completions / manual-clock advances) drives
a durable-WAL Onebox with the device-serving tier enabled, while three
seeded fault families fire:

- op chaos (the wire-chaos spec, rpc/chaos.py syntax): dispatches are
  dropped or delayed BEFORE anything is applied — the transport-retry
  shape, healed by the driver's retry loop exactly like `rpc/client`'s;
- store faults (engine/faults.FaultInjector): writes raise
  TransientStoreError before they apply, across frontend ops AND queue
  pumps (the at-least-once redelivery path);
- crashpoints (engine/crashpoints.py, `raise` mode): the process "dies"
  at an exact WAL/store commit offset; the driver discards the live
  box, runs the recovery fsck (gated CLEAN at every kill), recovers
  from the WAL prefix, rebuilds the cluster on the SAME manual clock,
  refreshes tasks, and replays the op — the in-process analog of the
  kill-anywhere crash matrix, mid-traffic.

The acceptance bar mirrors the chaos soak's, extended to the serving
tier: the chaotic run's final per-workflow mutable-state checksums must
be BYTE-IDENTICAL to a fault-free run of the same schedule,
`tpu.serving/parity-divergence` must be 0 while the tier actually took
transactions, every kill's recovery fsck must be clean, and a closing
`verify_all` (device bulk replay vs live states) must hold zero
divergence.

Determinism contract: ops execute in schedule order on one thread; all
decision/activity content is seeded by `(seed, workflow, schedule_id)`
— state-derived, so crash-replayed ops regenerate identical decisions;
time comes from one ManualTimeSource that survives recovery. Run ids
minted by reset/continue-as-new are uuid4 (engine-owned), which is why
the comparison is the canonical payload checksum — run-id strings are
not part of it, exactly as in the chaos soak.

Every box a scenario opens (and both regions of the replication profile)
runs its device tiers on the scenario's `device`: None means the card,
and without one the scenario raises.
"""
from __future__ import annotations

import os
import random
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.checksum import crc32_of_row, payload_row
from ..core.codec import serialize_history
from ..core.enums import EMPTY_EVENT_ID, DecisionType, EventType, WorkflowState
from ..core.events import HistoryBatch, HistoryEvent, RetryPolicy
from ..engine import crashpoints, walcheck
from ..engine.crashpoints import CrashPoint, SimulatedCrash
from ..engine.faults import FaultInjector, TransientStoreError, inject_faults
from ..engine.domain import DomainNotActiveError
from ..engine.durability import open_durable_stores, recover_stores
from ..engine.history_engine import Decision, InvalidRequestError, TaskToken
from ..engine.multicluster import ReplicatedClusters
from ..engine.onebox import Onebox
from ..engine.persistence import (
    EntityNotExistsError,
    WorkflowAlreadyStartedError,
)
from ..engine.replication import ReplicationTask, _DeviceApplier
from ..models.deciders import SignalDecider
from ..rpc import chaos as chaos_mod
from ..rpc.chaos import ChaosError
from ..utils import metrics as m
from ..utils.clock import ManualTimeSource

DOMAIN = "ilv-domain"

#: schedule_id past which the seeded decision script closes the run
_CLOSE_SCHED = 34
#: crashpoint sites the kill op rotates through — all fire on the
#: DRIVER thread (type=h filters WAL sites to history records written
#: inside the commit; the store sites live at the compound commits)
KILL_SITES = (
    (crashpoints.SITE_BEFORE_WRITE, "h"),
    (crashpoints.SITE_MID_RECORD, "h"),
    (crashpoints.SITE_AFTER_WRITE, "h"),
    (crashpoints.SITE_AFTER_FSYNC, "h"),
    ("store.execution.create_workflow", ""),
    ("store.execution.update_workflow", ""),
    ("store.history.append_batch", ""),
)


def _tl(wf: str) -> str:
    return f"tl-{wf}"


@dataclass
class _ActResp:
    """Poll-shaped carrier for a reconstructed activity token (the
    worker-held-token analog, see _direct_activity)."""

    token: object
    activity_id: str


@dataclass
class _DecisionResp:
    """Poll-shaped carrier for a reconstructed decision token (see
    _direct_decision)."""

    token: object
    history: list
    queries: tuple = ()
    query_only: bool = False


# ---------------------------------------------------------------------------
# Schedule generation
# ---------------------------------------------------------------------------


def build_schedule(seed: int, num_workflows: int = 4,
                   length: int = 120, kills: int = 2) -> List[dict]:
    """A seeded op schedule. `kills` crashpoint arms are woven in at
    seeded positions (the fault-free run skips them); every workflow is
    started early and the tail of the schedule drives all of them
    closed."""
    rng = random.Random(f"ilv-schedule:{seed}")
    wfs = [f"ilv-wf-{i}" for i in range(num_workflows)]
    ops: List[dict] = []
    # starts first: half by StartWorkflowExecution, half by the
    # signal-with-start race (the start arm)
    for i, wf in enumerate(wfs):
        if i % 2 == 0:
            ops.append({"op": "start", "wf": wf,
                        "retry": rng.random() < 0.3})
        else:
            ops.append({"op": "sws", "wf": wf, "name": "sws-first",
                        "request_id": f"sws-rid-{wf}"})
        ops.append({"op": "decide", "wf": wf})
    sig_seq = 0
    for _ in range(length):
        wf = rng.choice(wfs)
        r = rng.random()
        if r < 0.30:
            sig_seq += 1
            ops.append({"op": "signal", "wf": wf,
                        "name": f"sig-{sig_seq}",
                        "request_id": f"rid-{sig_seq}"})
            if rng.random() < 0.25:
                # the dedup race: the same request id again — must be a
                # no-op however the interleaving lands
                ops.append({"op": "signal", "wf": wf,
                            "name": f"sig-{sig_seq}",
                            "request_id": f"rid-{sig_seq}"})
        elif r < 0.40:
            # signal-with-start against a RUNNING workflow: the signal
            # arm of the race (request id dedups the crash-retry)
            sig_seq += 1
            ops.append({"op": "sws", "wf": wf,
                        "name": f"sws-{sig_seq}",
                        "request_id": f"sws-rid-{sig_seq}"})
        elif r < 0.62:
            ops.append({"op": "decide", "wf": wf})
        elif r < 0.74:
            ops.append({"op": "act", "wf": wf})
        elif r < 0.80:
            ops.append({"op": "query", "wf": wf})
            ops.append({"op": "decide", "wf": wf})
        elif r < 0.84:
            ops.append({"op": "advance",
                        "seconds": rng.choice([1, 2, 5, 11])})
        elif r < 0.88 and rng.random() < 0.5:
            ops.append({"op": "reset", "wf": wf})
            ops.append({"op": "decide", "wf": wf})
        elif r < 0.92:
            ops.append({"op": "cancel", "wf": wf})
            ops.append({"op": "decide", "wf": wf})
        else:
            ops.append({"op": "pump"})
    # weave the kill arms in at seeded interior positions
    lo = 2 * num_workflows + 1
    for k in range(kills):
        pos = rng.randrange(lo, max(lo + 1, len(ops) - 5))
        site, rtype = KILL_SITES[rng.randrange(len(KILL_SITES))]
        ops.insert(pos, {"op": "kill", "site": site, "type": rtype,
                         "hit": rng.randrange(1, 4)})
    return ops


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


@dataclass
class RunResult:
    checksums: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    kills: int = 0
    fsck_clean: int = 0
    fsck_findings: List[str] = field(default_factory=list)
    retries: int = 0
    chaos_drops: int = 0
    chaos_delays: int = 0
    store_faults: int = 0
    serving_transactions: int = 0
    parity_divergence: int = -1
    verify_total: int = 0
    verify_divergent: int = 0
    ops_executed: int = 0

    @property
    def ok(self) -> bool:
        return (not self.fsck_findings
                and self.parity_divergence == 0
                and self.verify_divergent == 0)


class _OpGate:
    """The in-process stand-in for wire chaos: the same seeded spec
    grammar (rpc/chaos.parse_spec), applied at the op-dispatch boundary
    — a drop/sever fires BEFORE anything executes (nothing applied, so
    a retry is always safe), a delay sleeps. The driver's retry loop is
    the `rpc/client._Pool` seat."""

    def __init__(self, spec: str, seed: int) -> None:
        self.chaos = chaos_mod.parse_spec(spec) if spec else None
        self._rng = random.Random(f"ilv-gate:{seed}")
        self.drops = 0
        self.delays = 0

    def __call__(self) -> None:
        c = self.chaos
        if c is None:
            return
        r_delay, r_jitter, r_drop = (self._rng.random(), self._rng.random(),
                                     self._rng.random())
        if c.delay > 0 and r_delay < c.delay:
            self.delays += 1
            time.sleep(r_jitter * c.delay_ms / 1000.0)
        if r_drop < c.drop + c.sever:
            self.drops += 1
            raise ChaosError("ilv gate: op dropped before dispatch")


class InterleaveDriver:
    """Executes one schedule against a durable serving-enabled Onebox."""

    _BENIGN = (WorkflowAlreadyStartedError, InvalidRequestError,
               EntityNotExistsError)

    def __init__(self, wal_path: str, seed: int, serving: bool = True,
                 chaos_spec: str = "", store_fault_rate: float = 0.0,
                 max_attempts: int = 60, device=None) -> None:
        self.wal_path = wal_path
        #: the device of every box this driver opens (None = the card)
        self.device = device
        self.seed = seed
        self.serving = serving
        self.max_attempts = max_attempts
        self.clock = ManualTimeSource()
        self.gate = _OpGate(chaos_spec, seed)
        self.injector = (FaultInjector(rate=store_fault_rate,
                                       seed=seed ^ 0x5a5a)
                         if store_fault_rate > 0 else None)
        self.result = RunResult()
        self.original_run: Dict[str, str] = {}
        self.box = None
        self._open_box(fresh=True)

    # -- box lifecycle -------------------------------------------------------

    def _open_box(self, fresh: bool) -> None:
        if fresh and not os.path.exists(self.wal_path):
            stores = open_durable_stores(self.wal_path)
        else:
            stores, _report = recover_stores(self.wal_path,
                                             verify_on_device=False,
                                             rebuild_on_device=False)
        if self.injector is not None:
            inject_faults(stores, self.injector)
        box = Onebox(num_hosts=1, num_shards=4, stores=stores,
                     time_source=self.clock, device=self.device)
        if self.serving:
            box.enable_serving()
        self.box = box
        if not fresh:
            # the task queues and matching backlog are not durable;
            # rebuilt state is (durability.recover_stores contract).
            # NO pump here: the refreshed tasks drain at the current
            # op's end like everyone else's — a mid-op recovery pump
            # would process cascades at a decision-in-flight state the
            # fault-free run never pumps in (child-started events would
            # BUFFER instead of recording, shifting history bytes).
            # Polls don't need it either: _direct_decision /
            # _direct_activity dispatch from the STORE when matching
            # comes up empty.
            self._retrying(lambda b: b.refresh_all_tasks(), allow_kill=False)

    def _recover_from_crash(self) -> None:
        """The armed crashpoint fired: the 'process' died mid-commit.
        fsck the surviving WAL (gated clean), recover, rebuild."""
        crashpoints.uninstall()
        self.result.kills += 1
        box, self.box = self.box, None
        try:
            if box.serving is not None:
                box.serving.stop()
            box.stores.wal.close()
        except Exception:
            pass
        report = walcheck.fsck(self.wal_path)
        if report.ok:
            self.result.fsck_clean += 1
        else:
            self.result.fsck_findings.extend(
                f"kill {self.result.kills}: {f.code} [{f.subject}] "
                f"{f.detail}" for f in report.findings)
        self._open_box(fresh=False)

    # -- dispatch ------------------------------------------------------------

    def _retrying(self, op, allow_kill: bool = True):
        """Run `op(box)` to convergence through the three fault
        families. `op` must be self-contained (re-resolves all state
        from the box), the retry-safety contract every arm of the real
        retry tier demands."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                if attempt:
                    self.result.retries += 1
                self.gate()
                return op(self.box)
            except ChaosError as exc:
                last = exc
            except TransientStoreError as exc:
                self.result.store_faults += 1
                last = exc
            except self._BENIGN:
                return None
            except SimulatedCrash as exc:
                if not allow_kill:
                    raise
                last = exc
                self._recover_from_crash()
        raise RuntimeError(
            f"op did not converge after {self.max_attempts} attempts "
            f"(last: {type(last).__name__}: {last})")

    # -- seeded worker behavior ----------------------------------------------

    def _decisions_for(self, wf: str, resp) -> List[Decision]:
        """The worker script: seeded by (seed, TOKEN workflow,
        schedule_id) so a crash-replayed decision regenerates the same
        commands — keyed to the workflow the task BELONGS to (a shared
        task list serves children too), never to which op polled it."""
        sched_id = resp.token.schedule_id
        tk_wf = resp.token.workflow_id
        rng = random.Random(f"ilv-decide:{self.seed}:{tk_wf}:{sched_id}")
        cancel_requested = any(
            e.event_type == EventType.WorkflowExecutionCancelRequested
            for e in resp.history)
        if cancel_requested:
            return [Decision(DecisionType.CancelWorkflowExecution, {})]
        if sched_id >= _CLOSE_SCHED:
            if rng.random() < 0.75:
                return [Decision(DecisionType.CompleteWorkflowExecution,
                                 {"result": b"done"})]
            return [Decision(DecisionType.FailWorkflowExecution,
                             {"reason": "ilv-fail"})]
        is_original = (resp.token.run_id == self.original_run.get(wf))
        if is_original and sched_id >= _CLOSE_SCHED // 2 \
                and rng.random() < 0.3:
            return [Decision(DecisionType.ContinueAsNewWorkflowExecution,
                             {"task_list": _tl(wf)})]
        menu = []
        for k in range(rng.randrange(0, 3)):
            r = rng.random()
            if r < 0.35:
                menu.append(Decision(DecisionType.ScheduleActivityTask, dict(
                    activity_id=f"a-{sched_id}-{k}", task_list=_tl(tk_wf),
                    schedule_to_start_timeout_seconds=60,
                    schedule_to_close_timeout_seconds=120,
                    start_to_close_timeout_seconds=60,
                    heartbeat_timeout_seconds=0)))
            elif r < 0.55:
                menu.append(Decision(DecisionType.StartTimer, dict(
                    timer_id=f"t-{sched_id}-{k}",
                    start_to_fire_timeout_seconds=rng.choice([1, 2, 5]))))
            elif r < 0.75:
                menu.append(Decision(DecisionType.RecordMarker,
                                     dict(marker_name="ilv-marker")))
            elif r < 0.9:
                menu.append(Decision(
                    DecisionType.UpsertWorkflowSearchAttributes,
                    dict(search_attributes={"CustomKeywordField": b"ilv"})))
            else:
                # the initiator's OWN name prefixes the child id: a
                # child's child nests ("X-child-25-child-2") instead of
                # colliding with the parent's other children or itself
                # — a collision's start outcome would hinge on the
                # squatter's open/closed state at task-processing time,
                # exactly the timing the checksum gate must not see
                child_id = f"{tk_wf}-child-{sched_id}"
                menu.append(Decision(
                    DecisionType.StartChildWorkflowExecution, dict(
                        workflow_id=child_id,
                        workflow_type="ilv-child",
                        task_list=_tl(child_id),
                        execution_start_to_close_timeout_seconds=300,
                        task_start_to_close_timeout_seconds=10)))
        return menu

    def _family(self, wf: str) -> List[str]:
        """`wf` plus its (grand)children, sorted — the driver's fixed
        service order over the per-workflow task lists. Derived from
        STATE, so both runs compute the same family at the same op."""
        def op(box):
            names = {k[1] for k in box.stores.execution.list_executions()}
            return [wf] + sorted(n for n in names
                                 if n.startswith(f"{wf}-child"))
        return self._retrying(op, allow_kill=False) or [wf]

    def _decide_once(self, wf: str) -> bool:
        """Serve ONE decision from `wf`'s family, parent first then
        children in name order — each workflow owns its task list, so
        which decision an op completes never depends on matching's
        interleaving of a shared queue. Poll and respond are SEPARATELY
        retried phases — the real worker's shape: a fault after the
        poll consumed the task must retry the RESPOND with the held
        token, never lose the completion by re-polling an empty list
        (the respond's "decision no longer current" benign arm covers
        the already-applied crash-retry). True when a decision task was
        actually completed."""
        for member in self._family(wf):
            resp = None
            for _ in range(8):
                resp = self._retrying(
                    lambda b: b.frontend.poll_for_decision_task(
                        DOMAIN, _tl(member)))
                if resp is None or not resp.query_only:
                    break
                # query-only tasks are stateless and NOT durable (a
                # crash drops them): answer and poll again, so whether
                # one existed never changes which decision this op
                # completes
                qo = resp

                def answer(box):
                    for qid, _qtype, _args in qo.queries:
                        box.frontend.respond_query_task_completed(
                            qo.execution, qid, b"ilv-answer")
                self._retrying(answer)
                resp = None
            if resp is None:
                resp = self._direct_decision(member)
            if resp is None:
                continue
            qr = {qid: b"ilv-answer" for qid, _t, _a in resp.queries}
            self._retrying(
                lambda b: b.frontend.respond_decision_task_completed(
                    resp.token, self._decisions_for(member, resp),
                    query_results=qr))
            return True
        return False

    def _act_once(self, wf: str) -> bool:
        for member in self._family(wf):
            resp = self._retrying(
                lambda b: b.frontend.poll_for_activity_task(
                    DOMAIN, _tl(member)))
            if resp is None:
                resp = self._direct_activity(member)
            if resp is None:
                continue
            rng = random.Random(
                f"ilv-act:{self.seed}:{member}:{resp.activity_id}")
            # one draw per COMPLETION, not per retry attempt
            roll = rng.random()

            def op(box):
                if roll < 0.8:
                    box.frontend.respond_activity_task_completed(resp.token)
                else:
                    box.frontend.respond_activity_task_failed(
                        resp.token, reason="ilv-act-fail")

            self._retrying(op)
            return True
        return False

    def _direct_decision(self, wf: str):
        """The state-driven dispatch seat: matching's in-memory queues
        are deliberately lossy (kills drop them; stale tasks from closed
        or reset runs eat poll slots benignly), so a None poll does NOT
        mean no decision is dispatchable. The STORE is the truth: an
        in-flight decision reconstructs its token (the worker held it
        across the server death), a scheduled one starts directly
        through the engine (exactly what the frontend's poll does after
        the matching pop, with a deterministic request id). This keeps
        the op's history effect a function of replicated STATE, never of
        matching-queue noise — the convergence invariant the
        fault-free-vs-chaos checksum gate rests on."""

        def op(box):
            domain_id = box.stores.domain.by_name(DOMAIN).domain_id
            run = box.stores.execution.get_current_run_id(domain_id, wf)
            ms = box.stores.execution.get_workflow(domain_id, wf, run)
            info = ms.execution_info
            if (info.state == WorkflowState.Completed
                    or info.decision_schedule_id == EMPTY_EVENT_ID):
                return None
            engine = box.route(wf)
            if info.decision_started_id > 0:
                token = TaskToken(domain_id=domain_id, workflow_id=wf,
                                  run_id=run,
                                  schedule_id=info.decision_schedule_id,
                                  started_id=info.decision_started_id,
                                  attempt=info.decision_attempt)
            else:
                token = engine.record_decision_task_started(
                    domain_id, wf, run, info.decision_schedule_id,
                    request_id=f"ilv-direct-{info.decision_schedule_id}")
            history = box.stores.history.read_events(domain_id, wf, run)
            queries = engine.queries.attach((domain_id, wf, run))
            return _DecisionResp(token=token, history=history,
                                 queries=tuple(queries))

        return self._retrying(op)

    def _direct_activity(self, wf: str):
        """The activity twin of _direct_decision: a started-uncompleted
        activity reconstructs its token; a pending unstarted one (its
        matching task lost or shadowed by stale entries) starts directly
        through the engine, lowest schedule id first — the FIFO order
        matching itself would have used."""

        def op(box):
            domain_id = box.stores.domain.by_name(DOMAIN).domain_id
            run = box.stores.execution.get_current_run_id(domain_id, wf)
            ms = box.stores.execution.get_workflow(domain_id, wf, run)
            if ms.execution_info.state == WorkflowState.Completed:
                return None
            pending = sorted(ms.pending_activity_info_ids.values(),
                             key=lambda ai: ai.schedule_id)
            for ai in pending:
                if ai.started_id > 0:
                    return _ActResp(
                        token=TaskToken(
                            domain_id=domain_id, workflow_id=wf,
                            run_id=run, schedule_id=ai.schedule_id,
                            started_id=ai.started_id, attempt=ai.attempt),
                        activity_id=ai.activity_id)
            for ai in pending:
                token = box.route(wf).record_activity_task_started(
                    domain_id, wf, run, ai.schedule_id,
                    request_id=f"ilv-direct-act-{ai.schedule_id}")
                return _ActResp(token=token, activity_id=ai.activity_id)
            return None

        return self._retrying(op)

    # -- op execution --------------------------------------------------------

    def _execute(self, item: dict) -> None:
        op = item["op"]
        wf = item.get("wf", "")
        if op == "start":
            retry = (RetryPolicy(initial_interval_seconds=1,
                                 backoff_coefficient=2.0,
                                 maximum_interval_seconds=8,
                                 maximum_attempts=3)
                     if item.get("retry") else None)
            self._retrying(lambda b: b.frontend.start_workflow_execution(
                DOMAIN, wf, "ilv-type", _tl(wf), retry_policy=retry))
            self._note_original(wf)
        elif op == "sws":
            self._retrying(
                lambda b: b.frontend.signal_with_start_workflow_execution(
                    DOMAIN, wf, item["name"], "ilv-type", _tl(wf),
                    request_id=item.get("request_id")))
            self._note_original(wf)
        elif op == "signal":
            self._retrying(lambda b: b.frontend.signal_workflow_execution(
                DOMAIN, wf, item["name"], request_id=item["request_id"]))
        elif op == "cancel":
            self._retrying(
                lambda b: b.frontend.request_cancel_workflow_execution(
                    DOMAIN, wf))
        elif op == "terminate":
            self._retrying(
                lambda b: b.frontend.terminate_workflow_execution(
                    DOMAIN, wf, reason="ilv-terminate"))
        elif op == "query":
            self._retrying(lambda b: b.frontend.query_workflow(
                DOMAIN, wf, "ilv-query"))
        elif op == "reset":
            self._reset(wf)
        elif op == "decide":
            self._decide_once(wf)
        elif op == "act":
            self._act_once(wf)
        elif op == "advance":
            self.clock.advance(int(item["seconds"] * 1_000_000_000))
            self._pump()
        elif op == "pump":
            self._pump()
        elif op == "kill":
            crashpoints.install(CrashPoint(
                site=item["site"], hit=item["hit"], mode="raise",
                record_type=item.get("type", "")))
        else:
            raise ValueError(f"unknown schedule op {op!r}")
        self._pump()

    def _note_original(self, wf: str) -> None:
        """Record the first run id AFTER the start op converged — never
        from the start call's return value, which a crash-retry can
        swallow (the baseline and chaos runs must agree on which run is
        eligible for the continue-as-new arm)."""
        if wf in self.original_run:
            return
        domain_id = self._retrying(
            lambda b: b.stores.domain.by_name(DOMAIN).domain_id,
            allow_kill=False)
        run = self._retrying(
            lambda b: b.stores.execution.get_current_run_id(domain_id, wf))
        if run is not None:
            self.original_run[wf] = run

    def _reset(self, wf: str) -> None:
        """Reset to the SECOND decision boundary, when the history has
        one. Retry-safe: a crash-retry must not reset twice, so the op
        re-checks the precondition (current run changed ⇒ applied)."""
        domain_id = self._retrying(
            lambda b: b.stores.domain.by_name(DOMAIN).domain_id,
            allow_kill=False)
        before = self._retrying(
            lambda b: b.stores.execution.get_current_run_id(domain_id, wf))
        if before is None:
            return

        issued = [False]

        def op(box):
            current = box.stores.execution.get_current_run_id(domain_id, wf)
            if current != before:
                return None  # an earlier attempt applied fully
            ms = box.stores.execution.get_workflow(domain_id, wf, current)
            if (ms.execution_info.state == WorkflowState.Completed
                    and not issued[0]):
                return None
            # issued[0] and Completed: OUR half-applied reset terminated
            # the base but died before the new run's commit point —
            # re-issuing the reset on the terminated base resumes it
            # (terminate is a no-op on a closed run), so a fault between
            # the two commits never strands a terminated-but-unreset run
            events = box.stores.history.read_events(domain_id, wf, current)
            starts = [e for e in events
                      if e.event_type == EventType.DecisionTaskStarted]
            if len(starts) < 2:
                return None
            finish_id = starts[1].id + 1
            if not any(e.id == finish_id and e.event_type
                       == EventType.DecisionTaskCompleted for e in events):
                return None  # boundary not a completed decision
            issued[0] = True
            return box.frontend.reset_workflow_execution(
                DOMAIN, wf, decision_finish_event_id=finish_id,
                reason="ilv-reset")

        self._retrying(op)

    def _pump(self, rounds: int = 20) -> None:
        """Drain the queue cascade to QUIESCENCE (bounded): child starts
        generate decision tasks generate child-started records — a fixed
        round count leaves the tail's timing hostage to how fault
        retries interleaved with task generation, which is exactly the
        noise the checksum gate must not see. Quiescent-at-every-op
        makes the transfer cascade's depth irrelevant."""
        for _ in range(rounds):
            if self._retrying(lambda b: b.pump_once()) == 0:
                break

    # -- run -----------------------------------------------------------------

    def run(self, schedule: List[dict], with_kills: bool = True) -> RunResult:
        wfs = sorted({item["wf"] for item in schedule if "wf" in item})
        self._retrying(lambda b: b.frontend.register_domain(DOMAIN))
        for item in schedule:
            if item["op"] == "kill" and not with_kills:
                continue
            self._execute(item)
            self.result.ops_executed += 1
        # an unfired arm must not leak into the close phase bookkeeping
        crashpoints.uninstall()
        self._finish(wfs)
        return self.result

    def _finish(self, wfs: List[str]) -> None:
        """Drive every workflow closed, quiesce, and collect the gates."""
        domain_id = self._retrying(
            lambda b: b.stores.domain.by_name(DOMAIN).domain_id,
            allow_kill=False)

        def is_open(wf: str) -> bool:
            def op(box):
                run = box.stores.execution.get_current_run_id(domain_id, wf)
                ms = box.stores.execution.get_workflow(domain_id, wf, run)
                return ms.execution_info.state != WorkflowState.Completed
            out = self._retrying(op)
            return bool(out)

        for wf in wfs:
            for _ in range(80):
                if not is_open(wf):
                    break
                progressed = self._decide_once(wf)
                progressed = self._act_once(wf) or progressed
                self._pump()
                if not progressed:
                    self.clock.advance(2_000_000_000)
                    self._pump()
            if is_open(wf):
                # cron chains / starved runs: the operator hammer
                self._execute({"op": "terminate", "wf": wf})
        # bounded quiesce (not pump_until_quiet: tasks parked for closed
        # runs may legitimately linger in the matching backlog)
        for _ in range(50):
            if self._retrying(lambda b: b.pump_once()) == 0:
                break
        box = self.box
        if box.serving is not None:
            box.serving.drain(timeout=30)
            self.result.serving_transactions = int(box.metrics.counter(
                m.SCOPE_TPU_SERVING, m.M_SERVING_TXNS))
            self.result.parity_divergence = int(box.metrics.counter(
                m.SCOPE_TPU_SERVING, m.M_SERVING_DIVERGENCE))
        else:
            self.result.parity_divergence = 0
        for wf in wfs:
            def op(b, wf=wf):
                run = b.stores.execution.get_current_run_id(domain_id, wf)
                ms = b.stores.execution.get_workflow(domain_id, wf, run)
                return (int(crc32_of_row(payload_row(ms))),
                        int(ms.execution_info.close_status))
            self.result.checksums[wf] = self._retrying(op)
        self.gate.chaos = None  # verify below runs fault-free
        if self.injector is not None:
            self.injector.rate = 0.0
        verify = box.tpu.verify_all()
        self.result.verify_total = verify.total
        self.result.verify_divergent = len(verify.divergent)
        self.result.chaos_drops = self.gate.drops
        self.result.chaos_delays = self.gate.delays
        if box.serving is not None:
            box.serving.stop()
        box.stores.wal.close()


# ---------------------------------------------------------------------------
# The scenario: chaotic run vs fault-free oracle run
# ---------------------------------------------------------------------------


def interleave_scenario(seed: int = 20260804, num_workflows: int = 4,
                        length: int = 90, kills: int = 2,
                        chaos_spec: str = "drop=0.05,delay=0.1,delay_ms=4,"
                                          "seed=11",
                        store_fault_rate: float = 0.04,
                        workdir: Optional[str] = None,
                        serving: bool = True, device=None) -> dict:
    """Run one seeded schedule twice — fault-free, then under the full
    chaos matrix — and gate the serving tier's zero-divergence story.
    Returns a JSON-able doc with `ok`. The two WALs go to `workdir`, by
    default a fresh temporary directory removed at the end."""
    schedule = build_schedule(seed, num_workflows=num_workflows,
                              length=length, kills=kills)
    own_dir = workdir is None
    if own_dir:
        workdir = tempfile.mkdtemp(prefix=f"ilv-{seed}-")
    paths = {name: os.path.join(workdir, f"ilv-{seed}-{name}.wal.jsonl")
             for name in ("baseline", "chaos")}
    for p in paths.values():
        if os.path.exists(p):
            os.remove(p)
    try:
        baseline = InterleaveDriver(
            paths["baseline"], seed, serving=serving, device=device).run(
                schedule, with_kills=False)
        chaotic = InterleaveDriver(
            paths["chaos"], seed, serving=serving, chaos_spec=chaos_spec,
            store_fault_rate=store_fault_rate, device=device).run(schedule)
    finally:
        crashpoints.uninstall()
        for p in paths.values():
            if os.path.exists(p):
                os.remove(p)
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    identical = chaotic.checksums == baseline.checksums
    doc = {
        "scenario": "interleave",
        "seed": seed, "workflows": num_workflows,
        "schedule_ops": len(schedule), "kills_armed": kills,
        "chaos_spec": chaos_spec, "store_fault_rate": store_fault_rate,
        "serving": serving,
        "baseline": {
            "checksums": baseline.checksums,
            "serving_transactions": baseline.serving_transactions,
            "verify_total": baseline.verify_total,
        },
        "chaos": {
            "checksums": chaotic.checksums,
            "kills_fired": chaotic.kills,
            "fsck_clean": chaotic.fsck_clean,
            "fsck_findings": chaotic.fsck_findings,
            "retries": chaotic.retries,
            "op_drops": chaotic.chaos_drops,
            "op_delays": chaotic.chaos_delays,
            "store_faults": chaotic.store_faults,
            "serving_transactions": chaotic.serving_transactions,
            "parity_divergence": chaotic.parity_divergence,
            "verify_total": chaotic.verify_total,
            "verify_divergent": chaotic.verify_divergent,
        },
        "checksums_identical": identical,
        "ok": bool(identical and baseline.ok and chaotic.ok
                   and chaotic.kills == chaotic.fsck_clean
                   and (not serving
                        or chaotic.serving_transactions > 0)),
    }
    return doc


# ---------------------------------------------------------------------------
# Replication-seam fuzz profile: the apply pump vs live standby traffic
# ---------------------------------------------------------------------------

DOMAIN_R = "rilv-domain"
TL_R = "rilv-tasklist"


def build_replication_schedule(seed: int, num_workflows: int = 4,
                               length: int = 48,
                               poisons: int = 2) -> List[dict]:
    """A seeded schedule over the REPLICATION seam. Phase 1 drives live
    traffic on the active cluster with incremental apply-pump drains
    woven between ops (each drain is one queue page — so applies land at
    arbitrary history offsets, not at quiet barriers); `poisons`
    semantically-invalid ReplicationTasks are injected at seeded
    positions. A single mid-schedule `promote` is the split-brain NDC
    version bump; phase 2 interleaves standby-side live signals/resets
    with DIVERGENT active-side writes and bidirectional drains. The
    closing `heal` converges both sides."""
    rng = random.Random(f"rilv-schedule:{seed}")
    wfs = [f"rilv-wf-{i}" for i in range(num_workflows)]
    ops: List[dict] = [{"op": "start", "wf": wf} for wf in wfs]
    ops.append({"op": "drain"})
    sig = 0
    for _ in range(length):
        wf = rng.choice(wfs)
        r = rng.random()
        if r < 0.55:
            sig += 1
            ops.append({"op": "signal", "wf": wf, "name": f"ra-{sig}"})
        elif r < 0.9:
            ops.append({"op": "drain"})
        else:
            sig += 1
            # the dedup race across the wire: the same signal twice
            ops.append({"op": "signal", "wf": wf, "name": f"ra-{sig}",
                        "request_id": f"rrid-{sig}"})
            ops.append({"op": "signal", "wf": wf, "name": f"ra-{sig}",
                        "request_id": f"rrid-{sig}"})
    # poison tasks: seeded interior positions, phase 1 only (version 1)
    lo = num_workflows + 2
    for _ in range(poisons):
        pos = rng.randrange(lo, len(ops))
        ops.insert(pos, {"op": "poison", "wf": rng.choice(wfs)})
    ops.append({"op": "promote"})
    for _ in range(length // 2):
        wf = rng.choice(wfs)
        r = rng.random()
        if r < 0.40:
            sig += 1
            ops.append({"op": "s_signal", "wf": wf, "name": f"rs-{sig}"})
        elif r < 0.55:
            ops.append({"op": "s_reset", "wf": wf})
        elif r < 0.70:
            sig += 1
            # divergent active-side write: the old active keeps going at
            # its version — the loser branch NDC must fork and retire
            ops.append({"op": "signal", "wf": wf, "name": f"rz-{sig}"})
        else:
            ops.append({"op": "drain_both"})
    ops.append({"op": "heal"})
    return ops


class _ReplicationDriver:
    """Executes one replication-seam schedule against an in-process
    two-cluster group (`ReplicatedClusters`): the active cluster's live
    engine, the standby's apply pump (host replicator + device twin),
    and — after the promote — the standby's OWN live engine writing at
    the bumped failover version."""

    def __init__(self, seed: int, num_workflows: int = 4,
                 device=None) -> None:
        self.seed = seed
        self.clusters = ReplicatedClusters(num_hosts=1, num_shards=4,
                                           device=device)
        # the serving tier feeds the seam under test: its post-flush
        # snapshot policy is what SHIPS records down the stream (the
        # wired Snapshotter.shipper), seeding the standby's device twin
        self.clusters.active.enable_serving()
        self.clusters.standby.enable_serving()
        self.clusters.register_global_domain(DOMAIN_R)
        self.wfs = [f"rilv-wf-{i}" for i in range(num_workflows)]
        # stays open through the whole run (signals land well short of
        # the close threshold) so every drain applies a LIVE history
        self.deciders = {wf: SignalDecider(expected_signals=999)
                         for wf in self.wfs}
        self.domain_id = self.clusters.active.stores.domain.by_name(
            DOMAIN_R).domain_id
        self.poisons_sent = 0
        self.drains = 0
        self.promoted = False

    # -- worker loop ---------------------------------------------------------

    def _drive(self, box, rounds: int = 200) -> None:
        """Bounded poll/decide/pump loop on one box (the taskpoller
        shape, in-package)."""
        for _ in range(rounds):
            progressed = box.pump_once() > 0
            while True:
                resp = box.frontend.poll_for_decision_task(DOMAIN_R, TL_R)
                if resp is None:
                    break
                progressed = True
                if resp.query_only:
                    for qid, _t, _a in resp.queries:
                        box.frontend.respond_query_task_completed(
                            resp.execution, qid, b"rilv")
                    continue
                decider = self.deciders[resp.token.workflow_id]
                try:
                    box.frontend.respond_decision_task_completed(
                        resp.token, decider.decide(resp.history))
                except InvalidRequestError:
                    pass  # stale token from a reset base run
                except DomainNotActiveError:
                    pass  # peer promotion landed on this workflow first
            if not progressed and box.matching.backlog() == 0:
                return

    # -- ops -----------------------------------------------------------------

    def _signal(self, box, wf: str, name: str, request_id=None) -> None:
        try:
            box.frontend.signal_workflow_execution(
                DOMAIN_R, wf, name, request_id=request_id)
        except (EntityNotExistsError, InvalidRequestError):
            return  # closed by an earlier close — benign
        except DomainNotActiveError:
            # the split-brain loser already saw the winner's higher
            # failover version on this workflow (reverse replication
            # raced ahead of its domain record): the write is rejected
            # typed, pre-apply — exactly the arbitration contract
            return
        self._drive(box)

    def _poison(self, wf: str) -> None:
        """Inject one semantically-invalid ReplicationTask: contiguity
        holds (first_event_id == the standby's expected next) but the
        batch completes an activity that was never scheduled — the host
        replicator must raise ReplayError and quarantine to the DLQ,
        never half-apply. Crafted after a full drain so the poison is at
        the head of the gap, not deduped behind real traffic."""
        self.clusters.replicate()
        run_id = self.clusters.standby.stores.execution.get_current_run_id(
            self.domain_id, wf)
        ms = self.clusters.standby.stores.execution.get_workflow(
            self.domain_id, wf, run_id)
        if ms.execution_info.state == WorkflowState.Completed:
            return
        next_id = ms.execution_info.next_event_id
        bad = HistoryBatch(
            domain_id=self.domain_id, workflow_id=wf, run_id=run_id,
            events=[HistoryEvent(
                id=next_id, event_type=EventType.ActivityTaskCompleted,
                version=1, timestamp=1,
                attrs=dict(scheduled_event_id=99990 + self.poisons_sent,
                           started_event_id=99991))])
        self.clusters.publisher.stores.queue.enqueue(
            "replication",
            ReplicationTask(domain_id=self.domain_id, workflow_id=wf,
                            run_id=run_id, first_event_id=next_id,
                            next_event_id=next_id + 1, version=1,
                            events_blob=serialize_history([bad])))
        self.poisons_sent += 1

    def _reset_standby(self, wf: str) -> None:
        """Live reset on the promoted standby: rewind to the second
        decision boundary when the history has one (the NDC fork + new
        run id that must replicate back and win)."""
        box = self.clusters.standby
        run_id = box.stores.execution.get_current_run_id(self.domain_id, wf)
        if run_id is None:
            return
        events = box.stores.history.read_events(self.domain_id, wf, run_id)
        starts = [e for e in events
                  if e.event_type == EventType.DecisionTaskStarted]
        if len(starts) < 2:
            return
        finish_id = starts[1].id + 1
        if not any(e.id == finish_id
                   and e.event_type == EventType.DecisionTaskCompleted
                   for e in events):
            return
        try:
            box.frontend.reset_workflow_execution(
                DOMAIN_R, wf, decision_finish_event_id=finish_id,
                reason="rilv-reset")
        except (EntityNotExistsError, InvalidRequestError):
            return
        self._drive(box)

    def _execute(self, item: dict) -> None:
        op, wf = item["op"], item.get("wf", "")
        c = self.clusters
        if op == "start":
            c.active.frontend.start_workflow_execution(
                DOMAIN_R, wf, "rilv-type", TL_R)
            self._drive(c.active)
        elif op == "signal":
            self._signal(c.active, wf, item["name"],
                         request_id=item.get("request_id"))
        elif op == "s_signal":
            self._signal(c.standby, wf, item["name"])
        elif op == "s_reset":
            self._reset_standby(wf)
        elif op == "drain":
            self.drains += 1
            c.active.serving.drain(timeout=30)  # flushes ship snapshots
            c.domain_processor.process_once()
            c.processor.process_once()
        elif op == "drain_both":
            self.drains += 1
            c.active.serving.drain(timeout=30)
            c.standby.serving.drain(timeout=30)
            c.processor.process_once()
            c.reverse_processor.process_once()
        elif op == "poison":
            self._poison(wf)
        elif op == "promote":
            c.replicate()  # standby forks from a replicated prefix
            c.split_brain_promote(DOMAIN_R)
            self.promoted = True
            self._drive(c.standby)
        elif op == "heal":
            c.heal(DOMAIN_R, "standby")
            self._drive(c.standby)
            self._drive(c.active)
            c.active.serving.drain(timeout=30)
            c.standby.serving.drain(timeout=30)
            c.replicate()
            c.replicate_reverse()
        else:
            raise ValueError(f"unknown replication schedule op {op!r}")

    def run(self, schedule: List[dict]) -> None:
        for item in schedule:
            self._execute(item)

    # -- gates ---------------------------------------------------------------

    def checksums(self, box) -> Dict[str, Tuple[str, int, int]]:
        """(current run id, canonical payload crc, close status) per
        workflow — the cross-region byte-identity gate."""
        out: Dict[str, Tuple[str, int, int]] = {}
        for wf in self.wfs:
            run_id = box.stores.execution.get_current_run_id(
                self.domain_id, wf)
            ms = box.stores.execution.get_workflow(self.domain_id, wf, run_id)
            out[wf] = (run_id, int(crc32_of_row(payload_row(ms))),
                       int(ms.execution_info.close_status))
        return out


def replication_interleave_scenario(seed: int = 20260806,
                                    num_workflows: int = 4,
                                    length: int = 48,
                                    poisons: int = 2, device=None) -> dict:
    """Fuzz the replication seam: one seeded
    schedule interleaves the standby's apply pump — host replicator +
    device twin, one queue page at a time — with live active-side
    traffic, a mid-schedule split-brain promotion (NDC failover-version
    bump), live signals/resets on the promoted standby racing divergent
    old-active writes, and seeded poison ReplicationTasks. Gates:

    - after heal, every workflow's (run id, canonical payload checksum,
      close status) is BYTE-IDENTICAL across both clusters;
    - the DLQ holds exactly the injected poisons — quarantine is
      DLQ-only (nothing else quarantined, nothing half-applied) and the
      reverse direction's DLQ is empty;
    - the device twin took real bulk applies with zero parity
      divergence on both registries;
    - closing verify_all (device bulk replay vs live state) is green on
      both clusters."""
    schedule = build_replication_schedule(
        seed, num_workflows=num_workflows, length=length, poisons=poisons)
    # fuzz histories are SHORT: tighten the snapshot policy so the
    # shipping seam actually carries records at this scale (the policy
    # is read at Snapshotter construction, inside the driver)
    knobs = {"CADENCE_TPU_SNAPSHOT_MIN_EVENTS": "1",
             "CADENCE_TPU_SNAPSHOT_EVERY_EVENTS": "4"}
    saved_env = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        driver = _ReplicationDriver(seed, num_workflows=num_workflows,
                                    device=device)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        driver.run(schedule)
        c = driver.clusters
        c.active.serving.drain(timeout=30)
        c.standby.serving.drain(timeout=30)
    finally:
        for box in (driver.clusters.active, driver.clusters.standby):
            if box.serving is not None:
                box.serving.stop()

    active_sums = driver.checksums(c.active)
    standby_sums = driver.checksums(c.standby)
    dlq = c.processor.read_dlq()
    reverse_dlq = c.reverse_processor.read_dlq()

    def _counter(box, scope, name):
        return int(box.metrics.counter(scope, name))

    device_applied = _counter(c.standby, m.SCOPE_REPLICATION,
                              m.M_REPL_DEVICE_APPLIED)
    device_divergence = (
        _counter(c.standby, m.SCOPE_REPLICATION, m.M_REPL_DEVICE_DIVERGENCE)
        + _counter(c.active, m.SCOPE_REPLICATION, m.M_REPL_DEVICE_DIVERGENCE))
    serving_divergence = (
        _counter(c.standby, m.SCOPE_TPU_SERVING, m.M_SERVING_DIVERGENCE)
        + _counter(c.active, m.SCOPE_TPU_SERVING, m.M_SERVING_DIVERGENCE))
    verify_active = c.active.tpu.verify_all()
    verify_standby = c.standby.tpu.verify_all()

    device_expected = _DeviceApplier(c.standby.tpu,
                                     c.standby.metrics).enabled()
    identical = active_sums == standby_sums
    dlq_exact = (len(dlq) == driver.poisons_sent
                 and len(reverse_dlq) == 0
                 and all("missing activity" in e.error for e in dlq))
    doc = {
        "scenario": "replication-interleave",
        "seed": seed, "workflows": num_workflows,
        "schedule_ops": len(schedule),
        "drains": driver.drains,
        "promoted": driver.promoted,
        "poisons_injected": driver.poisons_sent,
        "dlq_depth": len(dlq),
        "reverse_dlq_depth": len(reverse_dlq),
        "dlq_exact": dlq_exact,
        "active_checksums": active_sums,
        "standby_checksums": standby_sums,
        "checksums_identical": identical,
        "replication": {
            "applied": c.processor.applied,
            "deduped": c.processor.deduped,
            "resends": c.processor.resends,
            "snapshots_installed": c.processor.snapshots_installed,
            "device_enabled": device_expected,
            "device_applied": device_applied,
            "device_divergence": device_divergence,
        },
        "serving_divergence": serving_divergence,
        "verify": {
            "active": {"total": verify_active.total,
                       "divergent": len(verify_active.divergent)},
            "standby": {"total": verify_standby.total,
                        "divergent": len(verify_standby.divergent)},
        },
        "ok": bool(identical and dlq_exact and driver.promoted
                   and driver.poisons_sent == poisons
                   and device_divergence == 0
                   and serving_divergence == 0
                   and (not device_expected
                        or (device_applied > 0
                            and c.processor.snapshots_installed > 0))
                   and verify_active.ok and verify_standby.ok),
    }
    return doc
