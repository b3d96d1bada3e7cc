"""Generative history fuzzer: compose the FULL Cadence decision surface.

The five hand-written corpus generators (gen/corpus.py) each walk one
narrow groove of the semantic surface. This module is the compositional
counterpart: a seeded grammar that walks the workflow state machine
emitting *arbitrary legal histories* —

- every one of the 13 decision types (core/enums.DecisionType), each
  evidenced by its command event(s);
- mixed signal / timer / activity / child / marker / cancel
  interleavings, including buffered-event flush shapes (events landing
  in the decision-completed batch BEHIND the command events, the
  FlushBufferedEvents ordering);
- cron starts, workflow + activity retry policies, continue-as-new
  chains (batches carrying `new_run_events`, the FLAG_RUN_RESET row
  chain);
- transient decisions (DecisionTaskFailed/TimedOut) with NDC failover
  version bumps, bounded by the payload's version-history capacity;
- parent-attributed starts, child workflows with every parent-close
  policy, external signal/cancel legs with success AND failure results;
- external closes (Terminated / TimedOut) next to the decision closes.

Legality is enforced by construction: the walker tracks pending
decision / activity / timer / child / external tables and only emits
moves that are enabled, keeping each table within the device payload
capacities (core/checksum.PayloadLayout) so a generated corpus replays
clean on the base kernel — overflow pressure is the `overflow` suite's
job, not this one's.

Reproducibility contract: the same `(seed, workflow_index)` yields a
byte-identical history (string-seeded `random.Random`, exactly like
gen/corpus.py), across processes and platforms; `history_digest` is the
canonical byte witness the shrinker reports and tests pin. The grammar
is the JAX package's `gen/fuzz.py`, move for move, so both packages give
the same bytes for the same coordinates.

Promotion: interesting shapes become named `CorpusSpec` JSON files
(fuzz_specs/*.json) that `generate_corpus("fuzz:...")` consumers read.
`parity_run` drives the seeded corpora through this package's device
paths (dense and wirec replay, `TPUReplayEngine.verify_all` and the NDC
tree replay) on an explicit device.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.checksum import (
    DEFAULT_LAYOUT,
    STICKY_ROW_INDEX,
    PayloadLayout,
    payload_row,
)
from ..core.enums import DecisionType, EventType, TimeoutType
from ..core.events import HistoryBatch, HistoryEvent, RetryPolicy
from ..oracle.state_builder import StateBuilder
from .corpus import (
    HistoryWriter,
    _begin_decision_completed_batch,
    _run_decision,
    _schedule_decision,
    _start,
)

#: profiles weight the walker's move menu toward a shape family; "mixed"
#: is the uniform default every other profile perturbs
PROFILES = ("mixed", "signal_storm", "timer_churn", "child_tree",
            "ndc_conflict", "cron_retry", "chain")

#: events kept free at the tail for the close sequence
_CLOSE_MARGIN = 14

#: decision type → the event types that evidence it in a history (the
#: coverage counter's ground truth; RequestCancelActivityTask and
#: CancelTimer have success AND failure evidence events)
DECISION_EVIDENCE: Dict[DecisionType, Tuple[EventType, ...]] = {
    DecisionType.ScheduleActivityTask: (EventType.ActivityTaskScheduled,),
    DecisionType.RequestCancelActivityTask: (
        EventType.ActivityTaskCancelRequested,
        EventType.RequestCancelActivityTaskFailed),
    DecisionType.StartTimer: (EventType.TimerStarted,),
    DecisionType.CompleteWorkflowExecution: (
        EventType.WorkflowExecutionCompleted,),
    DecisionType.FailWorkflowExecution: (EventType.WorkflowExecutionFailed,),
    DecisionType.CancelTimer: (EventType.TimerCanceled,
                               EventType.CancelTimerFailed),
    DecisionType.CancelWorkflowExecution: (
        EventType.WorkflowExecutionCanceled,),
    DecisionType.RequestCancelExternalWorkflowExecution: (
        EventType.RequestCancelExternalWorkflowExecutionInitiated,),
    DecisionType.RecordMarker: (EventType.MarkerRecorded,),
    DecisionType.ContinueAsNewWorkflowExecution: (
        EventType.WorkflowExecutionContinuedAsNew,),
    DecisionType.StartChildWorkflowExecution: (
        EventType.StartChildWorkflowExecutionInitiated,),
    DecisionType.SignalExternalWorkflowExecution: (
        EventType.SignalExternalWorkflowExecutionInitiated,),
    DecisionType.UpsertWorkflowSearchAttributes: (
        EventType.UpsertWorkflowSearchAttributes,),
}


def _weights(profile: str) -> Dict[str, float]:
    """Move-menu weights per profile; every move stays reachable in
    every profile (coverage must not depend on profile choice, only the
    MIX does)."""
    w = {
        "signal": 1.0, "signal_dup": 0.3, "cancel_request": 0.15,
        "activity": 1.0, "activity_retry": 0.5, "timer": 1.0,
        "timer_cancel": 0.5, "timer_cancel_failed": 0.15,
        "act_cancel": 0.4, "act_cancel_failed": 0.15,
        "marker": 0.6, "upsert": 0.4, "child": 0.8,
        "ext_signal": 0.5, "ext_cancel": 0.4,
        "transient": 0.35, "buffered_flush": 0.4,
    }
    if profile == "signal_storm":
        w.update(signal=4.0, signal_dup=1.5, buffered_flush=1.2)
    elif profile == "timer_churn":
        w.update(timer=4.0, timer_cancel=2.0, timer_cancel_failed=0.5)
    elif profile == "child_tree":
        w.update(child=4.0, ext_signal=1.2, ext_cancel=1.0)
    elif profile == "ndc_conflict":
        w.update(transient=1.4, signal=1.5)
    elif profile == "cron_retry":
        w.update(activity_retry=2.0, activity=2.0)
    # "chain" and "mixed" use the base weights; chain biases the CLOSE
    return w


class _Walker:
    """One workflow's seeded walk over the enabled-move menu."""

    def __init__(self, rng: random.Random, w: HistoryWriter,
                 profile: str, target_events: int,
                 layout: PayloadLayout, chain: bool) -> None:
        self.rng = rng
        self.w = w
        self.profile = profile
        self.target = target_events
        self.layout = layout
        self.chain = chain
        self.weights = _weights(profile)
        #: pending tables (mirror the oracle's, bounded by the layout
        #: with one slot of headroom kept free)
        self.acts: List[Tuple[int, str, Optional[int], bool]] = []
        self.timers: List[Tuple[int, str]] = []
        self.children: List[Tuple[int, Optional[int]]] = []
        self.ext_signals: List[int] = []
        self.ext_cancels: List[int] = []
        self.sched_id: Optional[int] = None
        self.version_bumps = 0
        self.cancel_requested = False
        self.seq = 0

    def _next(self, kind: str) -> str:
        self.seq += 1
        return f"{kind}-{self.seq}"

    # -- enabled-move menu ---------------------------------------------------

    def _pick(self, moves: List[str]) -> str:
        weights = [self.weights.get(mv, 0.5) for mv in moves]
        return self.rng.choices(moves, weights=weights, k=1)[0]

    def run(self) -> None:
        cron = self.profile == "cron_retry" or self.rng.random() < 0.15
        _start(self.w, self.rng, cron=cron,
               retry=self.rng.random() < (0.6 if self.profile == "cron_retry"
                                          else 0.25),
               parent=self.rng.random() < (0.5 if self.profile == "child_tree"
                                           else 0.2))
        self.sched_id = 2
        if self.profile == "ndc_conflict":
            self.w.version = 1
        while self.w.next_id < self.target - _CLOSE_MARGIN:
            if self.sched_id is not None and self.rng.random() < 0.75:
                self._decision_cycle()
            else:
                self._arrival()
        self._close()
        assert self.w._open is None

    # -- decision cycles -----------------------------------------------------

    def _decision_cycle(self) -> None:
        cyc = _run_decision(self.w, self.sched_id)
        self.sched_id = None
        if (self.rng.random() < self.weights["transient"] * 0.5
                and self.version_bumps
                < self.layout.max_version_history_items - 3):
            # transient decision: fail/timeout, sometimes an NDC
            # failover version bump, then a fresh real schedule
            self.w.begin_batch()
            r = self.rng.random()
            if r < 0.4:
                self.w.add(EventType.DecisionTaskFailed,
                           scheduled_event_id=cyc.sched_id,
                           started_event_id=cyc.started_id)
            else:
                self.w.add(EventType.DecisionTaskTimedOut,
                           scheduled_event_id=cyc.sched_id,
                           started_event_id=cyc.started_id,
                           timeout_type=int(
                               TimeoutType.ScheduleToStart if r < 0.6
                               else TimeoutType.StartToClose))
            self.w.end_batch()
            if self.rng.random() < (0.8 if self.profile == "ndc_conflict"
                                    else 0.4):
                self.w.version += 100
                self.version_bumps += 1
            self.sched_id = _schedule_decision(self.w)
            return
        completed = _begin_decision_completed_batch(self.w, cyc)
        for _ in range(self.rng.randrange(0, 4)):
            self._decision_event(completed)
        # buffered flush: events that raced this decision land BEHIND
        # the command events in the same batch, then a fresh decision is
        # scheduled in-batch (the engine's _flush_buffered ordering)
        if self.rng.random() < self.weights["buffered_flush"] * 0.5:
            for _ in range(self.rng.randrange(1, 3)):
                self.w.add(EventType.WorkflowExecutionSignaled,
                           signal_name=self._next("buf-sig"))
            self.sched_id = _schedule_decision(self.w, in_batch=True)
        self.w.end_batch()

    def _decision_event(self, completed) -> None:
        """One command event inside the decision-completed batch."""
        w, rng = self.w, self.rng
        moves = ["marker", "upsert", "act_cancel_failed",
                 "timer_cancel_failed"]
        if len(self.acts) < self.layout.max_activities - 2:
            moves += ["activity", "activity_retry"]
        if len(self.timers) < self.layout.max_timers - 2:
            moves.append("timer")
        if self.timers:
            moves.append("timer_cancel")
        if self.acts:
            moves.append("act_cancel")
        if len(self.children) < self.layout.max_children - 2:
            moves.append("child")
        if len(self.ext_signals) < self.layout.max_signals - 2:
            moves.append("ext_signal")
        if len(self.ext_cancels) < self.layout.max_request_cancels - 2:
            moves.append("ext_cancel")
        mv = self._pick(moves)
        if mv in ("activity", "activity_retry"):
            attrs = dict(
                activity_id=self._next("act"),
                task_list=f"tl-{rng.randrange(3)}",
                schedule_to_start_timeout_seconds=rng.randrange(5, 60),
                schedule_to_close_timeout_seconds=rng.randrange(60, 180),
                start_to_close_timeout_seconds=rng.randrange(5, 60),
                heartbeat_timeout_seconds=rng.choice([0, 0, 3]),
            )
            if mv == "activity_retry":
                attrs["retry_policy"] = RetryPolicy(
                    initial_interval_seconds=1, backoff_coefficient=2.0,
                    maximum_interval_seconds=rng.choice([8, 16]),
                    maximum_attempts=rng.randrange(2, 5),
                )
            ev = w.add(EventType.ActivityTaskScheduled,
                       decision_task_completed_event_id=completed.id,
                       **attrs)
            self.acts.append((ev.id, attrs["activity_id"], None,
                              attrs["heartbeat_timeout_seconds"] > 0))
        elif mv == "timer":
            tid = self._next("timer")
            ev = w.add(EventType.TimerStarted, timer_id=tid,
                       start_to_fire_timeout_seconds=rng.randrange(1, 300),
                       decision_task_completed_event_id=completed.id)
            self.timers.append((ev.id, tid))
        elif mv == "timer_cancel":
            started_id, tid = self.timers.pop(
                rng.randrange(len(self.timers)))
            w.add(EventType.TimerCanceled, timer_id=tid,
                  started_event_id=started_id,
                  decision_task_completed_event_id=completed.id)
        elif mv == "timer_cancel_failed":
            w.add(EventType.CancelTimerFailed,
                  timer_id=self._next("no-such-timer"),
                  cause="TIMER_ID_UNKNOWN",
                  decision_task_completed_event_id=completed.id)
        elif mv == "act_cancel":
            sched_id, aid, started_id, hb = self.acts[
                rng.randrange(len(self.acts))]
            w.add(EventType.ActivityTaskCancelRequested, activity_id=aid,
                  decision_task_completed_event_id=completed.id)
        elif mv == "act_cancel_failed":
            w.add(EventType.RequestCancelActivityTaskFailed,
                  activity_id=self._next("no-such-act"),
                  cause="ACTIVITY_ID_UNKNOWN",
                  decision_task_completed_event_id=completed.id)
        elif mv == "marker":
            w.add(EventType.MarkerRecorded,
                  marker_name=rng.choice(["version", "side-effect",
                                          "local-activity", "echo"]),
                  decision_task_completed_event_id=completed.id)
        elif mv == "upsert":
            w.add(EventType.UpsertWorkflowSearchAttributes,
                  search_attributes={
                      f"CustomKeywordField{rng.randrange(3)}":
                      f"v{rng.randrange(8)}".encode()},
                  decision_task_completed_event_id=completed.id)
        elif mv == "child":
            ev = w.add(EventType.StartChildWorkflowExecutionInitiated,
                       workflow_id=self._next(f"child-{self.w.workflow_id}"),
                       workflow_type="child-type",
                       parent_close_policy=rng.randrange(3),
                       decision_task_completed_event_id=completed.id)
            self.children.append((ev.id, None))
        elif mv == "ext_signal":
            ev = w.add(EventType.SignalExternalWorkflowExecutionInitiated,
                       workflow_id=f"other-{rng.randrange(4)}", run_id="",
                       signal_name=self._next("poke"),
                       child_workflow_only=rng.random() < 0.3,
                       decision_task_completed_event_id=completed.id)
            self.ext_signals.append(ev.id)
        elif mv == "ext_cancel":
            ev = w.add(
                EventType.RequestCancelExternalWorkflowExecutionInitiated,
                workflow_id=f"other-{rng.randrange(4)}", run_id="",
                child_workflow_only=False,
                decision_task_completed_event_id=completed.id)
            self.ext_cancels.append(ev.id)

    # -- arrivals between decisions ------------------------------------------

    def _arrival(self) -> None:
        w, rng = self.w, self.rng
        moves = ["signal", "signal_dup"]
        if not self.cancel_requested:
            moves.append("cancel_request")
        if any(s is None for _, _, s, _ in self.acts):
            moves.append("act_start")
        if any(s is not None for _, _, s, _ in self.acts):
            moves.append("act_close")
        if self.timers:
            moves.append("timer_fire")
        if any(s is None for _, s in self.children):
            moves.append("child_start")
        if any(s is not None for _, s in self.children):
            moves.append("child_close")
        if self.ext_signals:
            moves.append("ext_signal_result")
        if self.ext_cancels:
            moves.append("ext_cancel_result")
        mv = self._pick(moves)
        if mv == "act_start":
            i = next(i for i, a in enumerate(self.acts) if a[2] is None)
            sched_id, aid, _, hb = self.acts[i]
            ev = w.single(EventType.ActivityTaskStarted,
                          scheduled_event_id=sched_id,
                          request_id=f"actpoll-{sched_id}", attempt=0)
            self.acts[i] = (sched_id, aid, ev.id, hb)
            return
        if mv == "child_start":
            i = next(i for i, c in enumerate(self.children) if c[1] is None)
            init_id, _ = self.children[i]
            if rng.random() < 0.15:
                # start failed: the child slot frees without ever starting
                w.begin_batch()
                w.add(EventType.StartChildWorkflowExecutionFailed,
                      initiated_event_id=init_id,
                      cause="WORKFLOW_ALREADY_RUNNING")
                if self.sched_id is None:
                    self.sched_id = _schedule_decision(w, in_batch=True)
                w.end_batch()
                self.children.pop(i)
                return
            ev = w.single(EventType.ChildWorkflowExecutionStarted,
                          initiated_event_id=init_id,
                          run_id=f"child-run-{init_id}")
            self.children[i] = (init_id, ev.id)
            return
        # remaining arrivals are "wake" batches: they schedule a decision
        # in-batch when none is pending (the signal-transaction shape)
        w.begin_batch()
        if mv == "signal" or mv == "signal_dup":
            attrs = dict(signal_name=self._next("sig"))
            if rng.random() < 0.5:
                # request-id carrying signals repopulate the dedup set on
                # replay; a dup id re-applied is the redelivery shape
                attrs["request_id"] = (f"rid-{self.w.workflow_id}-"
                                       f"{self.seq if mv == 'signal' else 1}")
            w.add(EventType.WorkflowExecutionSignaled, **attrs)
        elif mv == "cancel_request":
            w.add(EventType.WorkflowExecutionCancelRequested,
                  cause="fuzz-cancel")
            self.cancel_requested = True
        elif mv == "act_close":
            i = next(i for i, a in enumerate(self.acts) if a[2] is not None)
            sched_id, aid, started_id, hb = self.acts.pop(i)
            kind = rng.choice([EventType.ActivityTaskCompleted,
                               EventType.ActivityTaskFailed,
                               EventType.ActivityTaskTimedOut,
                               EventType.ActivityTaskCanceled])
            attrs = dict(scheduled_event_id=sched_id,
                         started_event_id=started_id)
            if kind == EventType.ActivityTaskFailed:
                attrs["reason"] = "fuzz-failure"
            elif kind == EventType.ActivityTaskTimedOut:
                attrs["timeout_type"] = int(rng.choice(
                    [TimeoutType.StartToClose, TimeoutType.Heartbeat]
                    if hb else [TimeoutType.StartToClose]))
                attrs["dt_nanos"] = 5_000_000_000
            w.add(kind, **attrs)
        elif mv == "timer_fire":
            started_id, tid = self.timers.pop(
                rng.randrange(len(self.timers)))
            w.add(EventType.TimerFired, timer_id=tid,
                  started_event_id=started_id, dt_nanos=2_000_000_000)
        elif mv == "child_close":
            i = next(i for i, c in enumerate(self.children)
                     if c[1] is not None)
            init_id, started_id = self.children.pop(i)
            w.add(rng.choice([EventType.ChildWorkflowExecutionCompleted,
                              EventType.ChildWorkflowExecutionFailed,
                              EventType.ChildWorkflowExecutionCanceled,
                              EventType.ChildWorkflowExecutionTimedOut,
                              EventType.ChildWorkflowExecutionTerminated]),
                  initiated_event_id=init_id, started_event_id=started_id)
        elif mv == "ext_signal_result":
            init_id = self.ext_signals.pop(
                rng.randrange(len(self.ext_signals)))
            w.add(EventType.ExternalWorkflowExecutionSignaled
                  if rng.random() < 0.7
                  else EventType.SignalExternalWorkflowExecutionFailed,
                  initiated_event_id=init_id)
        elif mv == "ext_cancel_result":
            init_id = self.ext_cancels.pop(
                rng.randrange(len(self.ext_cancels)))
            w.add(EventType.ExternalWorkflowExecutionCancelRequested
                  if rng.random() < 0.7
                  else EventType.RequestCancelExternalWorkflowExecutionFailed,
                  initiated_event_id=init_id)
        if self.sched_id is None:
            self.sched_id = _schedule_decision(w, in_batch=True)
        w.end_batch()

    # -- close ---------------------------------------------------------------

    def _close(self) -> None:
        w, rng = self.w, self.rng
        r = rng.random()
        if r < 0.08:
            # external closes need no decision cycle
            w.single(EventType.WorkflowExecutionTerminated
                     if rng.random() < 0.5
                     else EventType.WorkflowExecutionTimedOut,
                     reason="fuzz-close")
            return
        if self.sched_id is None:
            self.sched_id = _schedule_decision(w)
        cyc = _run_decision(w, self.sched_id)
        completed = _begin_decision_completed_batch(w, cyc)
        if self.cancel_requested:
            w.add(EventType.WorkflowExecutionCanceled,
                  decision_task_completed_event_id=completed.id)
            w.end_batch()
            return
        chain_p = 0.7 if self.profile == "chain" else 0.12
        if self.chain and rng.random() < chain_p:
            new_run_id = f"{w.run_id}-chained"
            w.add(EventType.WorkflowExecutionContinuedAsNew,
                  new_execution_run_id=new_run_id,
                  decision_task_completed_event_id=completed.id)
            # the new run's first transaction rides as new_run_events
            # (state_builder.go applyEvents newRunHistory shape); event
            # ids restart at 1 in the new run
            w2 = HistoryWriter(domain_id=w.domain_id,
                               workflow_id=w.workflow_id,
                               run_id=new_run_id, now=w.now,
                               version=w.version)
            _start(w2, rng)
            w.end_batch(new_run_events=[
                e for b in w2.batches for e in b.events])
            return
        # retry/cron-shaped walks close failing more often (their whole
        # point is the failure path); everything else mostly completes
        fail_p = 0.6 if self.profile == "cron_retry" else 0.3
        w.add(EventType.WorkflowExecutionFailed if rng.random() < fail_p
              else EventType.WorkflowExecutionCompleted,
              decision_task_completed_event_id=completed.id)
        w.end_batch()


# ---------------------------------------------------------------------------
# Public generation surface
# ---------------------------------------------------------------------------


def generate_fuzz_history(seed: int, workflow_index: int = 0,
                          target_events: int = 100,
                          profile: str = "mixed",
                          layout: PayloadLayout = DEFAULT_LAYOUT,
                          chain: bool = True) -> List[HistoryBatch]:
    """One workflow's fuzzed batched history; byte-identical for the same
    `(seed, workflow_index, target_events, profile)`."""
    if profile not in PROFILES:
        raise ValueError(f"unknown fuzz profile {profile!r} "
                         f"(have {PROFILES})")
    rng = random.Random(f"fuzz:{seed}:{profile}:{workflow_index}")
    w = HistoryWriter(workflow_id=f"fuzz-{profile}-wf-{workflow_index}",
                      run_id=f"run-{seed}-{workflow_index}")
    _Walker(rng, w, profile, target_events, layout, chain).run()
    return w.batches


def generate_fuzz_corpus(num_workflows: int, seed: int = 0,
                         target_events: int = 100,
                         profile: str = "mixed",
                         layout: PayloadLayout = DEFAULT_LAYOUT,
                         chain: bool = True) -> List[List[HistoryBatch]]:
    return [generate_fuzz_history(seed, i, target_events, profile,
                                  layout, chain)
            for i in range(num_workflows)]


def strip_new_run_events(histories: Sequence[List[HistoryBatch]]
                         ) -> List[List[HistoryBatch]]:
    """Store-shaped copies: a real HistoryStore persists each run's
    events separately — run 1's stored batches never carry the new run's
    (`as_history_batches` has no new_run_events). The verify_all /
    store-seeding drivers use this form so oracle, store, and device all
    replay the same bytes."""
    out: List[List[HistoryBatch]] = []
    for h in histories:
        out.append([
            HistoryBatch(domain_id=b.domain_id, workflow_id=b.workflow_id,
                         run_id=b.run_id, events=b.events,
                         request_id=b.request_id)
            if b.new_run_events else b
            for b in h])
    return out


def oracle_final_row(batches: List[HistoryBatch],
                     layout: PayloadLayout = DEFAULT_LAYOUT) -> np.ndarray:
    """The oracle's expected device payload row for one history,
    following a continue-as-new chain when the final batch carries
    new_run_events (the device row's final state is the LAST run's —
    encode_history FLAG_RUN_RESET chaining)."""
    sb = StateBuilder()
    sb.replay_history(batches)
    ms = sb.new_run_state if sb.new_run_state is not None else sb.ms
    row = payload_row(ms, layout)
    row[STICKY_ROW_INDEX] = 0
    return row


def history_digest(batches: Sequence[HistoryBatch]) -> str:
    """Canonical SHA256 of a batched history (the reproducibility
    witness: same (seed, index) → same digest, across processes)."""
    h = hashlib.sha256()
    for b in batches:
        for group in (b.events, b.new_run_events or ()):
            for e in group:
                h.update(repr((e.id, int(e.event_type), e.version,
                               e.timestamp, e.task_id,
                               sorted((k, repr(v))
                                      for k, v in e.attrs.items()))
                              ).encode())
        h.update(b"|batch|")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Coverage counter
# ---------------------------------------------------------------------------


def coverage(histories: Sequence[Sequence[HistoryBatch]]) -> dict:
    """Count generated event kinds and the decision types they evidence.

    Returns {"events": {name: n}, "decisions": {name: n},
    "missing_decisions": [names]} — the acceptance counter for "all 13
    decision types composed"."""
    event_counts: Dict[str, int] = {}
    for h in histories:
        for b in h:
            for group in (b.events, b.new_run_events or ()):
                for e in group:
                    name = EventType(e.event_type).name
                    event_counts[name] = event_counts.get(name, 0) + 1
    decision_counts: Dict[str, int] = {}
    for dt, evidence in DECISION_EVIDENCE.items():
        decision_counts[dt.name] = sum(
            event_counts.get(et.name, 0) for et in evidence)
    missing = [name for name, n in decision_counts.items() if n == 0]
    return {"events": event_counts, "decisions": decision_counts,
            "missing_decisions": missing}


# ---------------------------------------------------------------------------
# Store seeding (the verify_all driver's input shape)
# ---------------------------------------------------------------------------


def seed_stores(stores, histories: Sequence[List[HistoryBatch]],
                domain_id: str = "fuzz-domain") -> List[Tuple[str, str, str]]:
    """Persist store-shaped fuzz histories (new_run_events stripped) into
    a Stores bundle with the oracle's live mutable state, so
    `TPUReplayEngine.verify_all` has both sides of the zero-divergence
    contract. Returns the seeded keys."""
    keys: List[Tuple[str, str, str]] = []
    for h in strip_new_run_events(histories):
        first = h[0]
        key = (domain_id, first.workflow_id, first.run_id)
        for batch in h:
            stores.history.append_batch(*key, events=list(batch.events))
        ms = StateBuilder().replay_history(
            stores.history.as_history_batches(*key))
        ms.execution_info.domain_id = domain_id
        stores.execution.upsert_workflow(ms)
        keys.append(key)
    return keys


def fork_ndc_branch(stores, key: Tuple[str, str, str], seed: int,
                    extra_events: int = 3) -> int:
    """Turn one seeded single-lineage history into an NDC two-branch
    conflict tree: fork at a batch boundary, write a HIGHER-version
    signal suffix to the new branch, and make it current (the
    conflict-resolution winner). Returns the winning branch index.

    The losing branch keeps the original tail beyond the fork — the
    device must retain its items in the loser VH table while arbitrating
    the current pointer to the winner (conflict_resolver.go analog,
    exercised through `TPUReplayEngine.replay_tree_payloads`)."""
    rng = random.Random(f"fuzz-fork:{seed}:{key[1]}")
    events = stores.history.read_events(*key)
    # fork roughly mid-history, at a batch-first boundary the store knows
    fork_at = events[max(2, len(events) // 2)].id
    branch = stores.history.fork_branch(*key, source_branch=0,
                                        fork_event_id=fork_at)
    base = next(e for e in events if e.id == fork_at)
    version = max(e.version for e in events) + 100
    suffix = [
        HistoryEvent(id=fork_at + 1 + i,
                     event_type=EventType.WorkflowExecutionSignaled,
                     version=version,
                     timestamp=base.timestamp + 1_000_000 * (i + 1),
                     task_id=9_000 + i,
                     attrs={"signal_name": f"ndc-fork-{i}"})
        for i in range(rng.randrange(1, extra_events + 1))]
    stores.history.append_batch(*key, events=suffix, branch=branch)
    stores.history.set_current_branch(*key, branch=branch)
    return branch


# ---------------------------------------------------------------------------
# Promotion: named corpus specs
# ---------------------------------------------------------------------------

SPEC_SCHEMA = "fuzz-corpus-spec-v1"
SPEC_DIR = "fuzz_specs"


@dataclass(frozen=True)
class CorpusSpec:
    """A promoted fuzz shape: everything needed to regenerate the corpus
    byte-identically, plus the digest that proves it."""

    name: str
    seed: int
    workflows: int
    target_events: int
    profile: str = "mixed"
    chain: bool = True
    #: digest of workflow 0 at promotion time — regeneration is refused
    #: if the grammar drifted (the spec names BYTES, not intent)
    digest: str = ""
    note: str = ""

    def generate(self) -> List[List[HistoryBatch]]:
        histories = generate_fuzz_corpus(
            self.workflows, seed=self.seed,
            target_events=self.target_events, profile=self.profile,
            chain=self.chain)
        if self.digest and history_digest(histories[0]) != self.digest:
            raise ValueError(
                f"spec {self.name!r}: generator drifted — workflow 0 no "
                f"longer reproduces digest {self.digest[:12]}…")
        return histories


def make_spec(name: str, seed: int, workflows: int, target_events: int,
              profile: str = "mixed", chain: bool = True,
              note: str = "") -> CorpusSpec:
    digest = history_digest(generate_fuzz_history(
        seed, 0, target_events, profile, chain=chain))
    return CorpusSpec(name=name, seed=seed, workflows=workflows,
                      target_events=target_events, profile=profile,
                      chain=chain, digest=digest, note=note)


def save_spec(spec: CorpusSpec, root: str = ".") -> str:
    """The spec writer: fuzz_specs/<name>.json under `root`."""
    directory = os.path.join(root, SPEC_DIR)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{spec.name}.json")
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"schema": SPEC_SCHEMA, **asdict(spec)}, fh, indent=2,
                  sort_keys=True)
        fh.write("\n")
    return path


def parity_run(seeds: int = 50, workflows_per_seed: int = 4,
               target_events: int = 100,
               profiles: Sequence[str] = PROFILES,
               layout: PayloadLayout = DEFAULT_LAYOUT,
               ndc_forks: int = 2,
               chunk_workflows: int = 64,
               device=None) -> dict:
    """The history-parity driver: stream seeded fuzz corpora through
    BOTH device paths and the engine's verify tier on `device` (None:
    the card), gating zero oracle↔device divergence.

    Per seed, one workflow-per-profile corpus replays (a) dense
    `replay_corpus` vs `oracle_final_row`, (b) wirec `replay_wirec_to_crc`
    vs the oracle rows' CRC32s, and (c) `TPUReplayEngine.verify_all` over
    store-seeded (chain-stripped) histories — the resident/ladder
    configuration of record; `ndc_forks` of each seed's workflows
    additionally fork into NDC two-branch conflict trees checked through
    `replay_tree_payloads`. Returns the JSON-able doc a fuzz run records
    as FUZZ_r0N.json (the same keys as the JAX package's)."""
    import torch

    from ..core.checksum import crc32_of_row
    from ..device import resolve_device
    from ..engine.persistence import Stores
    from ..engine.tpu_engine import TPUReplayEngine
    from ..ops.encode import encode_corpus
    from ..ops.replay import replay_corpus, replay_wirec_to_crc
    from ..ops.wirec import pack_wirec

    dev = resolve_device(device)
    doc = {
        "seeds": seeds, "workflows_per_seed": workflows_per_seed,
        "target_events": target_events, "profiles": list(profiles),
        "workflows": 0, "events": 0,
        "dense_divergent": 0, "wirec_divergent": 0, "device_errors": 0,
        "verify_total": 0, "verify_divergent": 0, "verify_fallback": 0,
        "ndc_forked": 0, "ndc_divergent": 0,
    }
    all_histories: List[List[HistoryBatch]] = []
    for seed in range(seeds):
        histories: List[List[HistoryBatch]] = []
        for i in range(workflows_per_seed):
            profile = profiles[(seed + i) % len(profiles)]
            histories.append(generate_fuzz_history(
                seed, i, target_events, profile, layout))
        all_histories.extend(histories)
        expected = np.stack([oracle_final_row(h, layout)
                             for h in histories])
        rows, _crcs, errors = replay_corpus(histories, layout, device=dev)
        doc["device_errors"] += int((errors != 0).sum())
        doc["dense_divergent"] += int(
            ((rows != expected).any(axis=1) & (errors == 0)).sum())
        c = pack_wirec(encode_corpus(histories))
        wcrc, werr = replay_wirec_to_crc(
            torch.from_numpy(c.slab), torch.from_numpy(c.bases),
            torch.from_numpy(c.n_events), c.profile, layout, device=dev)
        wcrc = wcrc.cpu().numpy().astype(np.uint32)
        exp_crc = np.array([crc32_of_row(r) for r in expected],
                           dtype=np.uint32)
        doc["wirec_divergent"] += int(
            ((wcrc != exp_crc) & (werr.cpu().numpy() == 0)).sum())
        doc["workflows"] += len(histories)
        doc["events"] += sum(len(b.events) + len(b.new_run_events or ())
                             for h in histories for b in h)

    cov = coverage(all_histories)
    doc["decision_coverage"] = cov["decisions"]
    doc["missing_decisions"] = cov["missing_decisions"]
    doc["event_kinds"] = len(cov["events"])

    # the engine tier: store-seeded verify + NDC conflict forks
    stores = Stores()
    keys = seed_stores(stores, all_histories)
    engine = TPUReplayEngine(stores, layout,
                             chunk_workflows=chunk_workflows, device=dev)
    verify = engine.verify_all(keys)
    doc["verify_total"] = verify.total
    doc["verify_divergent"] = len(verify.divergent)
    doc["verify_fallback"] = len(verify.fallback)
    doc["verify_resident"] = len(verify.resident)
    doc["verify_escalated"] = len(verify.escalated)

    forked = keys[:ndc_forks * max(1, seeds // 2)]
    for i, key in enumerate(forked):
        fork_ndc_branch(stores, key, seed=i)
    if forked:
        rows, errors, branch = engine.replay_tree_payloads(forked)
        hs = stores.history
        for i, key in enumerate(forked):
            doc["ndc_forked"] += 1
            cur = hs.get_current_branch(*key)
            ms = StateBuilder().replay_history(
                hs.as_history_batches(*key, branch=cur))
            row = payload_row(ms, layout)
            row[STICKY_ROW_INDEX] = 0
            if (errors[i] != 0 or branch[i] != cur
                    or not (rows[i] == row).all()):
                doc["ndc_divergent"] += 1

    doc["ok"] = (doc["dense_divergent"] == 0 and doc["wirec_divergent"] == 0
                 and doc["device_errors"] == 0
                 and doc["verify_divergent"] == 0
                 and doc["ndc_divergent"] == 0
                 and not doc["missing_decisions"])
    return doc


# ---------------------------------------------------------------------------
# FUZZ_r0N.json trajectory files (the loadgen/report.py idiom)
# ---------------------------------------------------------------------------

TRAJECTORY_SCHEMA = "fuzz-trajectory-v1"
_TRAJ_PATTERN = "FUZZ_r{:02d}.json"


def write_fuzz_trajectory(doc: dict, root: str = ".",
                          path: Optional[str] = None) -> str:
    """Write one fuzz run's document to `path` or the next free
    FUZZ_r0N.json slot under `root`; returns the path."""
    if path is None:
        n = 1
        while os.path.exists(os.path.join(root, _TRAJ_PATTERN.format(n))):
            n += 1
        path = os.path.join(root, _TRAJ_PATTERN.format(n))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"schema": TRAJECTORY_SCHEMA, **doc}, fh, indent=2,
                  sort_keys=True, default=str)
        fh.write("\n")
    return path


def load_specs(root: str = ".") -> List[CorpusSpec]:
    """Every promoted spec under root/fuzz_specs, name-sorted."""
    directory = os.path.join(root, SPEC_DIR)
    if not os.path.isdir(directory):
        return []
    specs = []
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".json"):
            continue
        with open(os.path.join(directory, fname), encoding="utf-8") as fh:
            doc = json.load(fh)
        if doc.pop("schema", SPEC_SCHEMA) != SPEC_SCHEMA:
            continue
        specs.append(CorpusSpec(**doc))
    return specs
