"""Counters, gauges and histograms behind (scope, name) keys: the part of
the JAX package's utils/metrics.py that the escalation ladder and the
native wirec dispatcher write to, under the same scope and metric names.

A histogram here keeps its count, sum and max; the bucketed percentiles
and the Prometheus exposition of the full registry stay with the host
control plane, which the port has not taken over yet. Thread-safe.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

#: capacity-escalation ladder (engine/ladder.py)
SCOPE_TPU_FALLBACK = "tpu.fallback"
#: the native (C++) wirec encoder seam (native/wirec.py): the `available`
#: gauge says whether the compiled library loads in this process,
#: native-packs / python-packs count which encoder served each pack
SCOPE_TPU_NATIVE = "tpu.native"

#: gather + widened-K re-replay of flagged rows (the profiler's
#: `fallback` leg in the JAX package), observed in seconds per rung
M_PROFILE_FALLBACK = "fallback"
#: rows entering the ladder, rows resolved on the card, rows left for
#: the oracle; rows re-replayed at each rung are ladder_rung_rows(r)
M_LADDER_FLAGGED = "flagged-rows"
M_LADDER_RESOLVED = "resolved-rows"
M_LADDER_RESIDUAL = "residual-oracle-rows"
M_NATIVE_AVAILABLE = "available"
M_NATIVE_PACKS = "native-packs"
M_NATIVE_PY_PACKS = "python-packs"


def ladder_rung_rows(rung: int) -> str:
    """Per-rung row counter name: rows-rung1, rows-rung2, ..."""
    return f"rows-rung{rung}"


class MetricsRegistry:
    """In-process aggregates keyed by (scope, name)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], int] = {}
        self._gauges: Dict[Tuple[str, str], float] = {}
        self._histograms: Dict[Tuple[str, str], list] = {}  # [count, sum, max]

    def inc(self, scope: str, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[(scope, name)] = self._counters.get((scope, name), 0) + delta

    def observe(self, scope: str, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.setdefault((scope, name), [0, 0.0, float("-inf")])
            h[0] += 1
            h[1] += value
            h[2] = max(h[2], value)

    def gauge(self, scope: str, name: str, value: float) -> None:
        with self._lock:
            self._gauges[(scope, name)] = value

    def counter(self, scope: str, name: str) -> int:
        with self._lock:
            return self._counters.get((scope, name), 0)

    def gauge_value(self, scope: str, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get((scope, name), default)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Every series grouped by scope; a histogram shows as
        name.count, name.sum and name.max."""
        out: Dict[str, Dict[str, object]] = {}
        with self._lock:
            for (scope, name), v in self._counters.items():
                out.setdefault(scope, {})[name] = v
            for (scope, name), v in self._gauges.items():
                out.setdefault(scope, {})[name] = v
            for (scope, name), (count, total, peak) in self._histograms.items():
                out.setdefault(scope, {}).update(
                    {f"{name}.count": count, f"{name}.sum": total, f"{name}.max": peak})
        return out


#: the process-wide registry, for callers that pass none
DEFAULT_REGISTRY = MetricsRegistry()
