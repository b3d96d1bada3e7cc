"""Open-loop production traffic harness (bench/ + canary/ load tooling).

Reference: Cadence ships dedicated load tooling — `bench/` (the
configurable load-test workers) and `canary/` (the continuous liveness
suite) — because a workflow engine's real failure mode is OVERLOAD, not
low throughput. This package is that tooling for the wire cluster:

- `mixes.py`      seeded, reproducible open-loop traffic schedules
                  (starts, signals, signal-with-start, queries,
                  long-polls, resets, cron/retry) across many domains;
- `generator.py`  the open-loop driver — latency is clocked from each
                  op's INTENDED send time, so coordinated omission is
                  structurally impossible;
- `slo.py`        per-op/per-domain latency SLO evaluation (p50/p99/p999);
- `report.py`     LOADGEN_r0N.json trajectory files next to BENCH_r*.json;
- `scenarios.py`  end-to-end scenarios against a real `rpc/cluster.py`
                  cluster — notably the two-domain overload proof that
                  admission control sheds the aggressor while the victim
                  domain's p99 holds.
"""
from .generator import LoadGenerator, LoadReport
from .mixes import (
    DomainPlan,
    ScheduledOp,
    TrafficMix,
    build_schedule,
    trace_digest,
)
from .slo import SLO, SLOReport, evaluate_slos

__all__ = [
    "LoadGenerator", "LoadReport", "DomainPlan", "ScheduledOp",
    "TrafficMix", "build_schedule", "trace_digest", "SLO", "SLOReport",
    "evaluate_slos",
]
