"""Latency SLO evaluation: end-of-run percentiles + continuous burn rate.

An `SLO` names a slice of the traffic — op kind and/or domain, "*"
matching all — and the ceilings it must hold: latency percentiles
(measured from INTENDED send time, generator.py) and optionally a
maximum non-shed error rate. Sheds are NOT errors here: an overloaded
domain being rejected by admission control is the system working as
designed; the victim domain's latency holding is what the SLO gates.

Two evaluation modes share the SLO type:

- evaluate_slos(report, slos): one end-of-run verdict over a
  LoadReport's histograms (the original gate).
- BurnRateEvaluator(sampler, targets): CONTINUOUS evaluation over the
  time-series ring-buffer windows (utils/timeseries.py). A percentile
  ceiling "p99 ≤ L" is an error budget — at most 1% of requests may
  exceed L — and the burn rate over a trailing horizon is
  (observed over-ceiling fraction) / budget: 1.0 consumes the budget
  exactly at its sustainable rate. The evaluator computes it over a
  SHORT and a LONG horizon (classic multi-window burn alerting: page
  only when both burn, so a blip can't page and a slow leak can't
  hide), publishes slo/burn-rate-* gauges, and returns the pass/fail
  doc `admin top` embeds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..utils import metrics as m
from .generator import LoadReport

#: percentile ceiling → the fraction of requests allowed over it
BUDGETS = {"p50_ms": 0.50, "p99_ms": 0.01, "p999_ms": 0.001}

#: default multi-window horizons (seconds): short catches a fast burn,
#: long confirms it is sustained
DEFAULT_HORIZONS = (5.0, 60.0)


@dataclass(frozen=True)
class SLO:
    """Ceilings for one traffic slice; None = not gated."""

    op: str = "*"
    domain: str = "*"
    p50_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    p999_ms: Optional[float] = None
    max_error_rate: Optional[float] = None

    def matches(self, kind: str, domain: str) -> bool:
        return (self.op in ("*", kind)
                and self.domain in ("*", domain))


@dataclass
class SLOCheck:
    op: str
    domain: str
    metric: str
    limit: float
    observed: float
    ok: bool

    def as_dict(self) -> dict:
        return {"op": self.op, "domain": self.domain, "metric": self.metric,
                "limit": round(self.limit, 4),
                "observed": round(self.observed, 4), "ok": self.ok}


@dataclass
class SLOReport:
    checks: List[SLOCheck] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    @property
    def violations(self) -> List[SLOCheck]:
        return [c for c in self.checks if not c.ok]

    def as_dict(self) -> dict:
        return {"ok": self.ok,
                "checks": [c.as_dict() for c in self.checks],
                "violations": len(self.violations)}


def evaluate_slos(report: LoadReport, slos: List[SLO]) -> SLOReport:
    """Evaluate every SLO against every (op, domain) slice it matches.
    Latency limits check the slice's own histogram percentiles; the
    error-rate limit checks errors/sent (sheds excluded — they are the
    admission door doing its job, gated separately by the scenario)."""
    out = SLOReport()
    slices: List[Tuple[str, str]] = sorted(report.stats.keys())
    for slo in slos:
        for kind, domain in slices:
            if not slo.matches(kind, domain):
                continue
            stats = report.stats[(kind, domain)]
            if stats.sent == 0:
                continue
            pct: Dict[str, float] = report.percentiles(kind, domain)
            for metric, limit in (("p50_ms", slo.p50_ms),
                                  ("p99_ms", slo.p99_ms),
                                  ("p999_ms", slo.p999_ms)):
                if limit is None:
                    continue
                observed = pct[metric.replace("_ms", "")] * 1000.0
                out.checks.append(SLOCheck(
                    op=kind, domain=domain, metric=metric, limit=limit,
                    observed=observed, ok=observed <= limit))
            if slo.max_error_rate is not None:
                rate = stats.errors / stats.sent
                out.checks.append(SLOCheck(
                    op=kind, domain=domain, metric="error_rate",
                    limit=slo.max_error_rate, observed=rate,
                    ok=rate <= slo.max_error_rate))
    return out


# ---------------------------------------------------------------------------
# Continuous burn rate over the time-series ring
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BurnTarget:
    """One continuously-watched ceiling: the latency histogram at
    (scope, metric) must keep `percentile` of observations under
    `ceiling_s` seconds. `name` labels the slo/* gauges and the
    `admin top` row (label-in-name convention: one flat series per
    target, no label axes)."""

    name: str
    scope: str
    metric: str
    ceiling_s: float
    percentile: str = "p99_ms"  # key into BUDGETS

    @property
    def budget(self) -> float:
        return BUDGETS[self.percentile]


class BurnRateEvaluator:
    """Continuous multi-window burn-rate evaluation over a
    TimeSeriesSampler's ring.

    Construction registers each target's histogram for bucket-delta
    tracking (the sampler only retains per-window bucket deltas for
    tracked series); evaluate() then reads the over-ceiling fraction
    from the tracked deltas per horizon — bucket-granular, so the
    fraction is exact at bucket boundaries and conservative (rounds the
    violation UP to the enclosing bucket) between them.

    Designed to run as the sampler's on_sample hook: each window tick
    re-evaluates and republishes slo/* gauges, which the sampler's NEXT
    window then snapshots — so /timeseries windows carry the burn rates
    with one-window lag and `admin top` needs no extra endpoint.
    """

    def __init__(self, sampler, targets: List[BurnTarget],
                 horizons: Tuple[float, float] = DEFAULT_HORIZONS,
                 registry=None, threshold: float = 1.0) -> None:
        self.sampler = sampler
        self.targets = list(targets)
        self.horizons = tuple(horizons)
        self.registry = registry if registry is not None else sampler.registry
        #: burn rate both horizons must exceed before `alerting` trips
        self.threshold = threshold
        for target in self.targets:
            sampler.track_histogram(target.scope, target.metric)
            # pre-register so a scrape distinguishes "quiet" from "absent"
            for horizon in self.horizons:
                self.registry.gauge(
                    m.SCOPE_SLO,
                    f"burn-rate-{target.name}-{int(horizon)}s", 0.0)
            self.registry.gauge(m.SCOPE_SLO, f"alerting-{target.name}", 0.0)

    def evaluate(self, publish: bool = True,
                 now: Optional[float] = None) -> Dict:
        """One pass over every target; returns the doc `admin top`
        renders and (optionally) republishes the slo/* gauges."""
        rows = []
        for target in self.targets:
            row: Dict = {"name": target.name, "scope": target.scope,
                         "metric": target.metric,
                         "ceiling_s": target.ceiling_s,
                         "percentile": target.percentile,
                         "budget": target.budget, "windows": {}}
            burns = []
            for horizon in self.horizons:
                over, total = self.sampler.fraction_over(
                    target.scope, target.metric, target.ceiling_s,
                    horizon_s=horizon, now=now)
                fraction = (over / total) if total else 0.0
                burn = fraction / target.budget
                burns.append(burn)
                row["windows"][f"{int(horizon)}s"] = {
                    "over": over, "total": total,
                    "fraction": round(fraction, 6),
                    "burn_rate": round(burn, 4)}
                if publish:
                    self.registry.gauge(
                        m.SCOPE_SLO,
                        f"burn-rate-{target.name}-{int(horizon)}s", burn)
            alerting = bool(burns) and all(
                b > self.threshold for b in burns)
            row["alerting"] = alerting
            row["ok"] = not alerting
            if publish:
                self.registry.gauge(
                    m.SCOPE_SLO, f"alerting-{target.name}",
                    1.0 if alerting else 0.0)
            rows.append(row)
        doc = {"ok": all(r["ok"] for r in rows), "threshold": self.threshold,
               "horizons_s": list(self.horizons), "targets": rows}
        if publish:
            self.registry.gauge(
                m.SCOPE_SLO, "alerting",
                0.0 if doc["ok"] else 1.0)
        return doc
