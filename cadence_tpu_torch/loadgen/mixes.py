"""Traffic mixes: seeded open-loop schedules over frontend op kinds.

Reference: bench/lib's configurable test launches (basic, signal,
timer, cron, reset distributions). A schedule here is a FIXED list of
`ScheduledOp`s, each carrying its intended send offset `at_s` from the
run anchor — built entirely from the seed before any traffic flows, so:

- two builds with the same (plans, duration, seed) are byte-identical
  (`trace_digest` proves it — the reproducibility contract);
- arrival times are OPEN-LOOP: drawn from a Poisson process at the
  plan's RPS (or a uniform lattice), never derived from completions, so
  a slow server cannot retard the schedule (coordinated omission is
  impossible by construction — the generator measures from `at_s`).

Workflow-id population per domain:
- start-shaped ops (start / cron / retry) target UNIQUE churn ids —
  workers complete them, producing the closed-workflow population the
  oracle↔device checksum verify runs over;
- signal / query / long-poll / reset ops target a small POOL of
  long-lived workflows seeded before the run (pool ids are stable, so
  signals always have a live target);
- signal-with-start targets its own stable slot ids — the first op
  starts the workflow, later ones signal it (the dedup-race surface).
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

# -- op kinds ---------------------------------------------------------------

OP_START = "start"
OP_CRON_START = "cron-start"
OP_RETRY_START = "retry-start"
OP_SIGNAL = "signal"
OP_SIGNAL_WITH_START = "signal-with-start"
OP_QUERY = "query"
OP_LONGPOLL = "longpoll"
OP_RESET = "reset"
#: visibility read ops (ListWorkflowExecutions / ScanWorkflowExecutions
#: / CountWorkflowExecutions with a query string): the read side the
#: device-visibility tier serves; `arg` carries the seeded query
OP_LIST = "list"
OP_SCAN = "scan"
OP_COUNT = "count"

ALL_OPS = (OP_START, OP_CRON_START, OP_RETRY_START, OP_SIGNAL,
           OP_SIGNAL_WITH_START, OP_QUERY, OP_LONGPOLL, OP_RESET,
           OP_LIST, OP_SCAN, OP_COUNT)

#: kinds that target the long-lived pool population
POOL_OPS = (OP_SIGNAL, OP_QUERY, OP_LONGPOLL, OP_RESET)

#: kinds that carry a visibility query string in `arg`
VIS_OPS = (OP_LIST, OP_SCAN, OP_COUNT)

#: the seeded query pool visibility ops draw from: every shape the
#: generator's own populations produce (churn closes, pool stays open),
#: built-ins + boolean nesting — all expressible by the device mask
#: kernels, so a query-heavy run exercises the columnar path end to end
VIS_QUERIES = (
    "WorkflowType = 'lg-churn'",
    "WorkflowType = 'lg-pool' AND CloseStatus = -1",
    "CloseStatus = 0",
    "CloseStatus = -1",
    "CloseStatus = 0 OR CloseStatus = -1",
    "WorkflowType = 'lg-churn' AND StartTime > 0",
    "WorkflowType != 'lg-pool' AND (CloseStatus = 0 OR CloseStatus = 5)",
    "StartTime > 0 AND CloseTime >= 0",
)


@dataclass(frozen=True)
class ScheduledOp:
    """One intended request: WHAT to send and WHEN (offset seconds from
    the run anchor). Frozen + fully value-typed so schedules compare and
    digest deterministically."""

    index: int
    at_s: float
    kind: str
    domain: str
    workflow_id: str
    #: kind-specific argument (signal name; reset reason; unused else)
    arg: str = ""


@dataclass(frozen=True)
class TrafficMix:
    """Relative op-kind weights (zero/omitted = never drawn)."""

    name: str
    weights: Dict[str, float] = field(default_factory=dict)

    def normalized(self) -> List[tuple]:
        items = [(k, w) for k, w in sorted(self.weights.items()) if w > 0]
        total = sum(w for _, w in items)
        if not items or total <= 0:
            raise ValueError(f"mix {self.name!r} has no positive weights")
        return [(k, w / total) for k, w in items]


#: the default production-shaped blend (start-heavy with a realistic
#: read/signal tail — bench/lib's basic+signal+cron composite)
STANDARD_MIX = TrafficMix("standard", {
    OP_START: 0.30,
    OP_SIGNAL: 0.22,
    OP_SIGNAL_WITH_START: 0.10,
    OP_QUERY: 0.16,
    OP_LONGPOLL: 0.08,
    OP_CRON_START: 0.05,
    OP_RETRY_START: 0.05,
    OP_RESET: 0.04,
})

#: a pure-start hammer — the aggressor shape for overload scenarios
#: (every op charges the admission limiter exactly once)
START_ONLY_MIX = TrafficMix("start-only", {OP_START: 1.0})

#: read-dominated visibility traffic (the ES-query-heavy production
#: shape the device tier exists for): List/Scan/Count with seeded query
#: strings against a live churn+pool population, with enough writes
#: flowing that the device view's incremental appends stay exercised
QUERY_HEAVY_MIX = TrafficMix("query-heavy", {
    OP_LIST: 0.30,
    OP_COUNT: 0.18,
    OP_SCAN: 0.07,
    OP_QUERY: 0.05,
    OP_START: 0.20,
    OP_SIGNAL: 0.12,
    OP_SIGNAL_WITH_START: 0.08,
})

#: CLI mix selector (`load run --mix`)
MIXES = {
    "standard": STANDARD_MIX,
    "start-only": START_ONLY_MIX,
    "query-heavy": QUERY_HEAVY_MIX,
}


@dataclass(frozen=True)
class DomainPlan:
    """One domain's traffic: scheduled arrival rate + mix + pool size."""

    domain: str
    rps: float
    mix: TrafficMix = STANDARD_MIX
    pool_size: int = 8
    #: "poisson" (exponential inter-arrivals) or "uniform" (1/rps lattice)
    arrival: str = "poisson"

    def __post_init__(self) -> None:
        # rps <= 0 would divide by zero (uniform) or walk time backwards
        # forever (negative) in build_schedule — fail loudly at plan
        # construction, where the CLI's unvalidated --rps lands first
        if not self.rps > 0:
            raise ValueError(
                f"plan {self.domain!r}: rps must be > 0, got {self.rps}")


def pool_workflow_ids(plan: DomainPlan) -> List[str]:
    """The pool population the generator seeds before the run."""
    return [f"lg-{plan.domain}-pool-{i}" for i in range(plan.pool_size)]


def _draw_kind(rng: random.Random, normalized: Sequence[tuple]) -> str:
    r = rng.random()
    acc = 0.0
    for kind, w in normalized:
        acc += w
        if r < acc:
            return kind
    return normalized[-1][0]


def build_schedule(plans: Sequence[DomainPlan], duration_s: float,
                   seed: int) -> List[ScheduledOp]:
    """Build the full open-loop schedule: per-domain seeded streams
    (seeded by (seed, domain), so adding a domain never perturbs another
    domain's trace), merged by intended time and re-indexed."""
    ops: List[ScheduledOp] = []
    for plan in plans:
        rng = random.Random(f"{seed}:{plan.domain}")
        normalized = plan.mix.normalized()
        t, i = 0.0, 0
        while True:
            if plan.arrival == "uniform":
                t += 1.0 / plan.rps
            else:
                t += rng.expovariate(plan.rps)
            if t >= duration_s:
                break
            kind = _draw_kind(rng, normalized)
            if kind in POOL_OPS:
                wf = f"lg-{plan.domain}-pool-{rng.randrange(plan.pool_size)}"
            elif kind == OP_SIGNAL_WITH_START:
                wf = f"lg-{plan.domain}-sws-{rng.randrange(plan.pool_size)}"
            elif kind in VIS_OPS:
                # visibility reads scan the whole domain; arg is the
                # seeded query (drawn here so the trace digest pins it)
                wf = f"lg-{plan.domain}-vis"
            else:  # start-shaped: unique churn id
                wf = f"lg-{plan.domain}-{kind}-{i}"
            if kind in (OP_SIGNAL, OP_SIGNAL_WITH_START):
                arg = f"sig-{i}"
            elif kind in VIS_OPS:
                arg = VIS_QUERIES[rng.randrange(len(VIS_QUERIES))]
            else:
                arg = ""
            ops.append(ScheduledOp(index=0, at_s=round(t, 6), kind=kind,
                                   domain=plan.domain, workflow_id=wf,
                                   arg=arg))
            i += 1
    ops.sort(key=lambda op: (op.at_s, op.domain, op.workflow_id))
    return [ScheduledOp(index=j, at_s=op.at_s, kind=op.kind,
                        domain=op.domain, workflow_id=op.workflow_id,
                        arg=op.arg)
            for j, op in enumerate(ops)]


def trace_digest(schedule: Sequence[ScheduledOp]) -> str:
    """Canonical digest of a schedule — identical seeds must reproduce
    identical traffic traces (the trajectory file records it, so two
    LOADGEN runs are comparable only when their digests match)."""
    h = hashlib.sha256()
    for op in schedule:
        h.update(f"{op.index}|{op.at_s:.6f}|{op.kind}|{op.domain}|"
                 f"{op.workflow_id}|{op.arg}\n".encode())
    return h.hexdigest()
