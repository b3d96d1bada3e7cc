"""Persistence decorator tier: fault injection + call metrics.

Reference: common/persistence wraps every manager in decorators —
`persistenceErrorInjectionClients.go:51-101` (configurable error rates on
every call) and `persistenceMetricClients.go` (per-call counters/latency).
Here the same stacking wraps the store bundle's sub-stores in proxies:

    injector = FaultInjector(rate=0.1, seed=7)
    inject_faults(stores, injector)          # error-injection decorator
    instrument_stores(stores, metrics)       # metrics decorator

Injected failures raise TransientStoreError BEFORE the target method runs
(the reference injects on the client side of the store call), so a failed
write leaves the store untouched and the caller's retry semantics are
exercised for real.
"""
from __future__ import annotations

import random
from typing import Dict, Iterable, Optional, Tuple

from ..utils.metrics import MetricsRegistry

#: sub-stores of the bundle the decorators cover
STORE_NAMES = ("execution", "history", "task", "queue", "domain",
               "shard", "shard_tasks", "visibility")

#: read-ish prefixes skipped by default injection (the reference's config
#: can target any call; failing only mutations keeps tests deterministic)
_WRITE_PREFIXES = ("create", "update", "upsert", "append", "delete",
                   "insert", "enqueue", "fork", "set_", "record", "complete",
                   "lease", "restore", "drop")


class TransientStoreError(Exception):
    """Injected store failure (the retryable persistence error class)."""


class FaultInjector:
    """Decides which store calls fail.

    Two modes, combinable:
    - `rate`: every targeted call fails with probability `rate` (seeded
      RNG — runs are reproducible);
    - `fail_next(store, method, times)`: scripted deterministic failures
      for targeted tests.
    """

    def __init__(self, rate: float = 0.0, seed: int = 0,
                 writes_only: bool = True) -> None:
        self.rate = rate
        self.writes_only = writes_only
        self._rng = random.Random(seed)
        self._scripted: Dict[Tuple[str, str], int] = {}
        self.injected = 0

    def fail_next(self, store: str, method: str, times: int = 1) -> None:
        self._scripted[(store, method)] = (
            self._scripted.get((store, method), 0) + times)

    def should_fail(self, store: str, method: str) -> bool:
        left = self._scripted.get((store, method), 0)
        if left > 0:
            self._scripted[(store, method)] = left - 1
            self.injected += 1
            return True
        if self.rate <= 0:
            return False
        if self.writes_only and not method.startswith(_WRITE_PREFIXES):
            return False
        if self._rng.random() < self.rate:
            self.injected += 1
            return True
        return False


class _StoreProxy:
    """Transparent method-intercepting wrapper over one sub-store."""

    def __init__(self, name: str, target, injector: Optional[FaultInjector],
                 metrics: Optional[MetricsRegistry]) -> None:
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_injector", injector)
        object.__setattr__(self, "_metrics", metrics)

    def __getattr__(self, attr):
        value = getattr(object.__getattribute__(self, "_target"), attr)
        if not callable(value) or attr.startswith("__"):
            return value
        name = object.__getattribute__(self, "_name")
        injector = object.__getattribute__(self, "_injector")
        metrics = object.__getattribute__(self, "_metrics")

        def wrapped(*args, **kwargs):
            if injector is not None and injector.should_fail(name, attr):
                if metrics is not None:
                    metrics.inc(f"persistence.{name}", "errors-injected")
                raise TransientStoreError(
                    f"injected failure: {name}.{attr}")
            if metrics is not None:
                metrics.inc(f"persistence.{name}", "requests")
                try:
                    return value(*args, **kwargs)
                except Exception:
                    metrics.inc(f"persistence.{name}", "errors")
                    raise
            return value(*args, **kwargs)

        return wrapped

    def __setattr__(self, attr, value) -> None:
        # attach_wal and friends mutate sub-store state; forward it
        setattr(object.__getattribute__(self, "_target"), attr, value)


def inject_faults(stores, injector: FaultInjector,
                  names: Iterable[str] = STORE_NAMES,
                  metrics: Optional[MetricsRegistry] = None) -> None:
    """Wrap the bundle's sub-stores with the error-injection decorator
    (persistenceErrorInjectionClients.go analog). Mutates the bundle in
    place — every component resolving stores.<name> dynamically sees the
    decorated store."""
    for name in names:
        target = getattr(stores, name)
        setattr(stores, name, _StoreProxy(name, target, injector, metrics))


def instrument_stores(stores, metrics: MetricsRegistry,
                      names: Iterable[str] = STORE_NAMES) -> None:
    """Metrics-only decorator (persistenceMetricClients.go analog)."""
    for name in names:
        target = getattr(stores, name)
        setattr(stores, name, _StoreProxy(name, target, None, metrics))
