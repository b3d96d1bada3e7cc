"""Golden event-stream corpus generators.

Produces the five BASELINE workload shapes (BASELINE.md / BASELINE.json
configs) as synthetic-but-valid workflow histories, used for:

- differential testing: oracle replayer vs device kernel (checksum parity),
- benchmarking: bench.py replays generated corpora at scale.

Workload shapes mirror the reference load/canary suites:
  basic            bench/load/basic/stressWorkflow.go
                   (chained no-op activities driven by decision tasks)
  echo_signal      canary/echo.go, canary/signal.go
  timer_retry      canary/timeout.go, canary/retry.go
  concurrent_child canary/concurrentExec.go, canary/localactivity.go
                   (wide decision batches, child workflows)
  ndc              cross-cluster replication shapes (version bumps mid-history,
                   transient decisions, continue-as-new), per
                   host/ndc/integration_test.go patterns

Histories are generated as *batches* (one batch per would-be transaction),
because batch boundaries are semantically visible: LastFirstEventID,
ScheduledEventBatchID and transient-decision schedule IDs all depend on them
(state_builder.go:642, mutable_state_builder.go:2163).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.enums import EMPTY_EVENT_ID, EventType, TimeoutType
from ..core.events import HistoryBatch, HistoryEvent, RetryPolicy

SUITES = ("basic", "echo_signal", "timer_retry", "concurrent_child", "ndc")


@dataclass
class HistoryWriter:
    """Builds valid batched histories with monotonically increasing event IDs
    and timestamps."""

    domain_id: str = "default-domain-id"
    workflow_id: str = "wf"
    run_id: str = "run"
    version: int = 0
    next_id: int = 1
    now: int = 1_700_000_000_000_000_000  # deterministic epoch, unix nanos
    batches: List[HistoryBatch] = field(default_factory=list)
    _open: Optional[List[HistoryEvent]] = None
    task_id: int = 1000

    def begin_batch(self) -> None:
        assert self._open is None, "batch already open"
        self._open = []

    def end_batch(self, new_run_events: Optional[List[HistoryEvent]] = None) -> None:
        assert self._open, "no open batch or empty batch"
        self.batches.append(
            HistoryBatch(
                domain_id=self.domain_id,
                workflow_id=self.workflow_id,
                run_id=self.run_id,
                events=self._open,
                request_id=f"req-{self.workflow_id}-{self.run_id}",
                new_run_events=new_run_events,
            )
        )
        self._open = None

    def add(self, event_type: EventType, dt_nanos: int = 1_000_000, **attrs: Any) -> HistoryEvent:
        assert self._open is not None, "no open batch"
        self.now += dt_nanos
        self.task_id += 1
        ev = HistoryEvent(
            id=self.next_id,
            event_type=event_type,
            version=self.version,
            timestamp=self.now,
            task_id=self.task_id,
            attrs=attrs,
        )
        self.next_id += 1
        self._open.append(ev)
        return ev

    def single(self, event_type: EventType, **attrs: Any) -> HistoryEvent:
        self.begin_batch()
        ev = self.add(event_type, **attrs)
        self.end_batch()
        return ev

    def execution_cancel_requested(self) -> bool:
        return any(
            e.event_type == EventType.WorkflowExecutionCancelRequested
            for b in self.batches for e in b.events
        )


def _start(w: HistoryWriter, rng: random.Random, *, cron: bool = False,
           retry: bool = False, parent: bool = False) -> None:
    """Start batch: WorkflowExecutionStarted + DecisionTaskScheduled, matching
    the active side's first transaction (historyEngine.go:583-529)."""
    attrs: Dict[str, Any] = dict(
        task_list="tl-default",
        workflow_type=f"workflow-type-{rng.randrange(4)}",
        execution_start_to_close_timeout_seconds=3600,
        task_start_to_close_timeout_seconds=10,
        first_execution_run_id=w.run_id,
    )
    if cron:
        attrs["cron_schedule"] = "* * * * *"
        attrs["first_decision_task_backoff_seconds"] = 60
        attrs["initiator"] = None
    if retry:
        attrs["retry_policy"] = RetryPolicy(
            initial_interval_seconds=1,
            backoff_coefficient=2.0,
            maximum_interval_seconds=10,
            maximum_attempts=3,
            expiration_interval_seconds=0,
        )
        attrs["attempt"] = 0
    if parent:
        attrs["parent_workflow_domain_id"] = "parent-domain-id"
        attrs["parent_workflow_id"] = f"parent-{w.workflow_id}"
        attrs["parent_run_id"] = "parent-run"
        attrs["parent_initiated_event_id"] = 5
    w.begin_batch()
    w.add(EventType.WorkflowExecutionStarted, **attrs)
    w.add(EventType.DecisionTaskScheduled, task_list="tl-default",
          start_to_close_timeout_seconds=10, attempt=0)
    w.end_batch()


def _decision_started(w: HistoryWriter, sched_id: int) -> HistoryEvent:
    return w.single(EventType.DecisionTaskStarted, scheduled_event_id=sched_id,
                    request_id=f"poll-{sched_id}")


@dataclass
class _DecisionCycle:
    sched_id: int
    started_id: int


def _begin_decision_completed_batch(w: HistoryWriter, cyc: _DecisionCycle) -> HistoryEvent:
    w.begin_batch()
    return w.add(EventType.DecisionTaskCompleted, scheduled_event_id=cyc.sched_id,
                 started_event_id=cyc.started_id)


def _schedule_decision(w: HistoryWriter, in_batch: bool = False) -> int:
    if not in_batch:
        ev = w.single(EventType.DecisionTaskScheduled, task_list="tl-default",
                      start_to_close_timeout_seconds=10, attempt=0)
    else:
        ev = w.add(EventType.DecisionTaskScheduled, task_list="tl-default",
                   start_to_close_timeout_seconds=10, attempt=0)
    return ev.id


def _run_decision(w: HistoryWriter, sched_id: int) -> _DecisionCycle:
    started = _decision_started(w, sched_id)
    return _DecisionCycle(sched_id=sched_id, started_id=started.id)


def _close(w: HistoryWriter, rng: random.Random, cyc: _DecisionCycle,
           close_type: EventType = EventType.WorkflowExecutionCompleted) -> None:
    completed = _begin_decision_completed_batch(w, cyc)
    w.add(close_type, decision_task_completed_event_id=completed.id)
    w.end_batch()


# ---------------------------------------------------------------------------
# Suite: basic (chained activities, no-op decisions)
# ---------------------------------------------------------------------------


def gen_basic(rng: random.Random, w: HistoryWriter, target_events: int = 100) -> None:
    _start(w, rng)
    sched_id = 2
    act_seq = 0
    while w.next_id < target_events - 6:
        cyc = _run_decision(w, sched_id)
        completed = _begin_decision_completed_batch(w, cyc)
        act = w.add(
            EventType.ActivityTaskScheduled,
            activity_id=f"act-{act_seq}",
            task_list="tl-default",
            schedule_to_start_timeout_seconds=60,
            schedule_to_close_timeout_seconds=120,
            start_to_close_timeout_seconds=60,
            heartbeat_timeout_seconds=0,
        )
        act_seq += 1
        w.end_batch()
        started = w.single(EventType.ActivityTaskStarted, scheduled_event_id=act.id,
                           request_id=f"actpoll-{act.id}")
        w.begin_batch()
        w.add(EventType.ActivityTaskCompleted, scheduled_event_id=act.id,
              started_event_id=started.id)
        sched_id = _schedule_decision(w, in_batch=True)
        w.end_batch()
    cyc = _run_decision(w, sched_id)
    _close(w, rng, cyc)


# ---------------------------------------------------------------------------
# Suite: echo_signal (mixed signal/decision events)
# ---------------------------------------------------------------------------


def gen_echo_signal(rng: random.Random, w: HistoryWriter, target_events: int = 100) -> None:
    _start(w, rng)
    sched_id = 2
    sig = 0
    while w.next_id < target_events - 8:
        cyc = _run_decision(w, sched_id)
        completed = _begin_decision_completed_batch(w, cyc)
        if rng.random() < 0.4:
            w.add(EventType.MarkerRecorded, marker_name="echo",
                  decision_task_completed_event_id=completed.id)
        w.end_batch()
        # external signals arrive; each signal transaction also schedules a
        # decision when none is pending (historyEngine.go:2202 signal path)
        n_signals = rng.randrange(1, 4)
        for i in range(n_signals):
            w.begin_batch()
            w.add(EventType.WorkflowExecutionSignaled, signal_name=f"sig-{sig}")
            sig += 1
            if i == 0:
                sched_id = _schedule_decision(w, in_batch=True)
            w.end_batch()
    cyc = _run_decision(w, sched_id)
    _close(w, rng, cyc)


# ---------------------------------------------------------------------------
# Suite: timer_retry (timers firing/canceled, activity retries & timeouts)
# ---------------------------------------------------------------------------


def gen_timer_retry(rng: random.Random, w: HistoryWriter, target_events: int = 100) -> None:
    _start(w, rng, retry=rng.random() < 0.5)
    sched_id = 2
    timer_seq = 0
    act_seq = 0
    while w.next_id < target_events - 10:
        cyc = _run_decision(w, sched_id)
        completed = _begin_decision_completed_batch(w, cyc)
        choice = rng.random()
        if choice < 0.45:
            # start a timer, let it fire
            timer = w.add(EventType.TimerStarted, timer_id=f"timer-{timer_seq}",
                          start_to_fire_timeout_seconds=rng.randrange(1, 30),
                          decision_task_completed_event_id=completed.id)
            timer_seq += 1
            w.end_batch()
            w.begin_batch()
            w.add(EventType.TimerFired, timer_id=timer.get("timer_id"),
                  started_event_id=timer.id, dt_nanos=2_000_000_000)
            sched_id = _schedule_decision(w, in_batch=True)
            w.end_batch()
        elif choice < 0.7:
            # start a timer then cancel it on the next decision
            timer = w.add(EventType.TimerStarted, timer_id=f"timer-{timer_seq}",
                          start_to_fire_timeout_seconds=300,
                          decision_task_completed_event_id=completed.id)
            timer_seq += 1
            sched_id2 = _schedule_decision(w, in_batch=True)
            w.end_batch()
            cyc2 = _run_decision(w, sched_id2)
            completed2 = _begin_decision_completed_batch(w, cyc2)
            w.add(EventType.TimerCanceled, timer_id=timer.get("timer_id"),
                  started_event_id=timer.id,
                  decision_task_completed_event_id=completed2.id)
            sched_id = _schedule_decision(w, in_batch=True)
            w.end_batch()
            continue
        else:
            # activity with retry policy that times out / fails then retries
            act = w.add(
                EventType.ActivityTaskScheduled,
                activity_id=f"act-{act_seq}",
                task_list="tl-default",
                schedule_to_start_timeout_seconds=10,
                schedule_to_close_timeout_seconds=60,
                start_to_close_timeout_seconds=5,
                heartbeat_timeout_seconds=rng.choice([0, 3]),
                retry_policy=RetryPolicy(
                    initial_interval_seconds=1, backoff_coefficient=2.0,
                    maximum_interval_seconds=8, maximum_attempts=4,
                ),
            )
            act_seq += 1
            w.end_batch()
            started = w.single(EventType.ActivityTaskStarted,
                               scheduled_event_id=act.id, request_id=f"actpoll-{act.id}",
                               attempt=0)
            w.begin_batch()
            if rng.random() < 0.5:
                w.add(EventType.ActivityTaskTimedOut, scheduled_event_id=act.id,
                      started_event_id=started.id,
                      timeout_type=int(TimeoutType.StartToClose),
                      dt_nanos=5_000_000_000)
            else:
                w.add(EventType.ActivityTaskFailed, scheduled_event_id=act.id,
                      started_event_id=started.id, reason="synthetic-failure")
            sched_id = _schedule_decision(w, in_batch=True)
            w.end_batch()
            continue
        # loop continues with pending decision sched_id
    cyc = _run_decision(w, sched_id)
    _close(w, rng, cyc, EventType.WorkflowExecutionCompleted
           if rng.random() < 0.8 else EventType.WorkflowExecutionFailed)


# ---------------------------------------------------------------------------
# Suite: concurrent_child (wide decision batches, children, externals)
# ---------------------------------------------------------------------------


def gen_concurrent_child(rng: random.Random, w: HistoryWriter,
                         target_events: int = 120) -> None:
    _start(w, rng, parent=rng.random() < 0.3)
    sched_id = 2
    child_seq = 0
    act_seq = 0
    while w.next_id < target_events - 24:
        cyc = _run_decision(w, sched_id)
        completed = _begin_decision_completed_batch(w, cyc)
        # wide batch: several parallel activities + child workflows + externals
        acts = []
        for _ in range(rng.randrange(2, 5)):
            acts.append(w.add(
                EventType.ActivityTaskScheduled,
                activity_id=f"act-{act_seq}",
                task_list=f"tl-{rng.randrange(3)}",
                schedule_to_start_timeout_seconds=60,
                schedule_to_close_timeout_seconds=120,
                start_to_close_timeout_seconds=60,
                heartbeat_timeout_seconds=0,
            ))
            act_seq += 1
        children = []
        for _ in range(rng.randrange(0, 3)):
            children.append(w.add(
                EventType.StartChildWorkflowExecutionInitiated,
                workflow_id=f"child-{w.workflow_id}-{child_seq}",
                workflow_type="child-type",
                parent_close_policy=rng.randrange(3),
                decision_task_completed_event_id=completed.id,
            ))
            child_seq += 1
        ext_signal = None
        if rng.random() < 0.4:
            ext_signal = w.add(
                EventType.SignalExternalWorkflowExecutionInitiated,
                workflow_id="other-wf", run_id="", signal_name="poke",
                child_workflow_only=False,
                decision_task_completed_event_id=completed.id,
            )
        ext_cancel = None
        if rng.random() < 0.25:
            ext_cancel = w.add(
                EventType.RequestCancelExternalWorkflowExecutionInitiated,
                workflow_id="other-wf", run_id="", child_workflow_only=False,
                decision_task_completed_event_id=completed.id,
            )
        if rng.random() < 0.3:
            w.add(EventType.UpsertWorkflowSearchAttributes,
                  search_attributes={"CustomKeywordField": b"v"},
                  decision_task_completed_event_id=completed.id)
        w.end_batch()

        # activities complete
        for act in acts:
            started = w.single(EventType.ActivityTaskStarted,
                               scheduled_event_id=act.id,
                               request_id=f"actpoll-{act.id}")
            w.begin_batch()
            w.add(EventType.ActivityTaskCompleted, scheduled_event_id=act.id,
                  started_event_id=started.id)
            w.end_batch()
        # children start and complete
        for ci in children:
            started = w.single(EventType.ChildWorkflowExecutionStarted,
                               initiated_event_id=ci.id,
                               run_id=f"child-run-{ci.id}")
            w.begin_batch()
            w.add(rng.choice([
                EventType.ChildWorkflowExecutionCompleted,
                EventType.ChildWorkflowExecutionFailed,
                EventType.ChildWorkflowExecutionCanceled,
            ]), initiated_event_id=ci.id, started_event_id=started.id)
            w.end_batch()
        if ext_signal is not None:
            w.single(EventType.ExternalWorkflowExecutionSignaled,
                     initiated_event_id=ext_signal.id)
        if ext_cancel is not None:
            w.single(
                EventType.ExternalWorkflowExecutionCancelRequested
                if rng.random() < 0.7
                else EventType.RequestCancelExternalWorkflowExecutionFailed,
                initiated_event_id=ext_cancel.id,
            )
        sched_id = _schedule_decision(w)
    cyc = _run_decision(w, sched_id)
    _close(w, rng, cyc)


# ---------------------------------------------------------------------------
# Suite: ndc (multi-version histories, transient decisions, cancel request)
# ---------------------------------------------------------------------------


def gen_ndc(rng: random.Random, w: HistoryWriter, target_events: int = 100) -> None:
    w.version = 1
    _start(w, rng)
    sched_id = 2
    timer_seq = 0
    failovers = 0
    while w.next_id < target_events - 12:
        cyc = _run_decision(w, sched_id)
        r = rng.random()
        if r < 0.25 and failovers < 4:
            # decision fails/times out; version bump simulates failover;
            # exercises the transient-decision path (state_builder.go:237-281)
            w.begin_batch()
            if rng.random() < 0.5:
                w.add(EventType.DecisionTaskTimedOut, scheduled_event_id=cyc.sched_id,
                      started_event_id=cyc.started_id,
                      timeout_type=int(TimeoutType.StartToClose))
            else:
                w.add(EventType.DecisionTaskFailed, scheduled_event_id=cyc.sched_id,
                      started_event_id=cyc.started_id)
            w.end_batch()
            failovers += 1
            w.version += 100  # failover version bump
            sched_id = _schedule_decision(w)
        elif r < 0.5:
            completed = _begin_decision_completed_batch(w, cyc)
            timer = w.add(EventType.TimerStarted, timer_id=f"t-{timer_seq}",
                          start_to_fire_timeout_seconds=5,
                          decision_task_completed_event_id=completed.id)
            timer_seq += 1
            w.end_batch()
            w.begin_batch()
            w.add(EventType.TimerFired, timer_id=timer.get("timer_id"),
                  started_event_id=timer.id, dt_nanos=5_000_000_000)
            sched_id = _schedule_decision(w, in_batch=True)
            w.end_batch()
        elif r < 0.6:
            # cancel requested externally mid-flight
            completed = _begin_decision_completed_batch(w, cyc)
            w.end_batch()
            w.begin_batch()
            w.add(EventType.WorkflowExecutionCancelRequested, cause="ndc-test")
            sched_id = _schedule_decision(w, in_batch=True)
            w.end_batch()
        else:
            completed = _begin_decision_completed_batch(w, cyc)
            w.add(EventType.MarkerRecorded, marker_name="ndc-marker",
                  decision_task_completed_event_id=completed.id)
            w.end_batch()
            w.begin_batch()
            w.add(EventType.WorkflowExecutionSignaled, signal_name="ndc-signal")
            sched_id = _schedule_decision(w, in_batch=True)
            w.end_batch()
    cyc = _run_decision(w, sched_id)
    if w.execution_cancel_requested():
        completed = _begin_decision_completed_batch(w, cyc)
        w.add(EventType.WorkflowExecutionCanceled,
              decision_task_completed_event_id=completed.id)
        w.end_batch()
    else:
        _close(w, rng, cyc)


# ---------------------------------------------------------------------------
# Suite: overflow (adversarial — a controlled fraction of workflows exceed
# the device pending-activity table, forcing the oracle fallback)
# ---------------------------------------------------------------------------

#: fraction of overflow-suite workflows engineered to exceed the device
#: tables (SURVEY §7 hard part 3: the fallback must be MEASURED under
#: pressure, not always zero by construction)
OVERFLOW_FRACTION = 0.025


def gen_overflow(rng: random.Random, w: HistoryWriter,
                 target_events: int = 100,
                 capacity_hint: int = 16) -> None:
    """Mostly gen_basic, but OVERFLOW_FRACTION of workflows pile up
    `capacity_hint + 8` concurrently-pending activities in one decision —
    past the device table, valid for the oracle (which has no capacity),
    so the device flags TABLE_OVERFLOW and the engine falls back."""
    if rng.random() >= OVERFLOW_FRACTION:
        gen_basic(rng, w, target_events)
        return
    _start(w, rng)
    cyc = _run_decision(w, 2)
    completed = _begin_decision_completed_batch(w, cyc)
    acts = [w.add(
        EventType.ActivityTaskScheduled,
        activity_id=f"flood-{i}", task_list="tl-default",
        schedule_to_start_timeout_seconds=60,
        schedule_to_close_timeout_seconds=120,
        start_to_close_timeout_seconds=60, heartbeat_timeout_seconds=0,
    ) for i in range(capacity_hint + 8)]
    w.end_batch()
    # drain them so the workflow still closes cleanly on the oracle
    sched_id = None
    for act in acts:
        started = w.single(EventType.ActivityTaskStarted,
                           scheduled_event_id=act.id,
                           request_id=f"actpoll-{act.id}")
        w.begin_batch()
        w.add(EventType.ActivityTaskCompleted, scheduled_event_id=act.id,
              started_event_id=started.id)
        if act is acts[-1]:
            sched_id = _schedule_decision(w, in_batch=True)
        w.end_batch()
    cyc = _run_decision(w, sched_id)
    _close(w, rng, cyc)


_GENERATORS = {
    "basic": gen_basic,
    "echo_signal": gen_echo_signal,
    "timer_retry": gen_timer_retry,
    "concurrent_child": gen_concurrent_child,
    "ndc": gen_ndc,
    "overflow": gen_overflow,
}


def generate_history(suite: str, seed: int, workflow_index: int = 0,
                     target_events: int = 100) -> List[HistoryBatch]:
    """Generate one workflow's batched history for a suite.

    `"fuzz"` / `"fuzz:<profile>"` route to the compositional fuzzer
    (gen/fuzz.py) — the whole decision surface behind the same
    `(suite, seed, workflow_index)` addressing every consumer (tests,
    promoted CorpusSpecs) already speaks."""
    if suite == "fuzz" or suite.startswith("fuzz:"):
        from .fuzz import generate_fuzz_history
        profile = suite.partition(":")[2] or "mixed"
        return generate_fuzz_history(seed, workflow_index,
                                     target_events=target_events,
                                     profile=profile)
    # string seeding is stable across processes (random.seed version 2 hashes
    # the string with sha512), unlike tuple __hash__ under PYTHONHASHSEED
    rng = random.Random(f"{seed}:{suite}:{workflow_index}")
    w = HistoryWriter(workflow_id=f"{suite}-wf-{workflow_index}",
                      run_id=f"run-{workflow_index}")
    _GENERATORS[suite](rng, w, target_events=target_events)
    assert w._open is None
    return w.batches


def generate_corpus(suite: str, num_workflows: int, seed: int = 0,
                    target_events: int = 100) -> List[List[HistoryBatch]]:
    """Generate a corpus: one batched history per workflow."""
    return [
        generate_history(suite, seed, i, target_events) for i in range(num_workflows)
    ]
