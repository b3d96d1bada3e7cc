"""Circuit breakers: per-target fail-fast around cross-process calls.

Reference: the Go server fronts every remote dependency with
hystrix-style breakers (yarpc outbound middleware; persistence clients
get them via the error-injection/retry decorator stack). The observable
contract reduced here:

- CLOSED: calls flow; failures within a sliding window are counted, and
  tripping the threshold (consecutive failures OR failure-rate over a
  minimum throughput) opens the circuit.
- OPEN: calls fail immediately with `CircuitOpenError` (no connect, no
  socket timeout burn) until `reset_timeout_s` elapses.
- HALF-OPEN: one probe call is let through; success closes the circuit,
  failure re-opens it (with the reset clock restarted).

A `BreakerRegistry` keys breakers by target address, so every client
tier (`rpc/client._Pool`, `RemoteCluster`, `RemoteMatching`) sharing the
registry shares breaker state per peer. State transitions emit through a
metrics registry when one is attached (gauge: 0=closed, 1=open,
2=half-open; counter: transitions), so /metrics shows which peers are
being shed.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from . import flightrecorder

CLOSED = 0
OPEN = 1
HALF_OPEN = 2

_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half-open"}


class CircuitOpenError(ConnectionError):
    """The breaker for this target is open: the call was shed without
    touching the network. A ConnectionError subclass, so existing
    dead-peer handling (routers trying the next host) degrades
    naturally."""


class ServiceBusy(Exception):
    """Typed server-overload/shed signal surfaced to API callers (the
    reference's ServiceBusyError): the frontend tier translates a
    breaker-open into this, so callers back off instead of queueing
    behind a dead host. Picklable — crosses the wire as-is."""


class CircuitBreaker:
    """One target's breaker (thread-safe; monotonic clock)."""

    def __init__(self, failure_threshold: int = 5,
                 failure_rate: float = 0.5, min_throughput: int = 10,
                 reset_timeout_s: float = 5.0,
                 window_s: float = 30.0) -> None:
        self.failure_threshold = failure_threshold
        self.failure_rate = failure_rate
        self.min_throughput = min_throughput
        self.reset_timeout_s = reset_timeout_s
        self.window_s = window_s
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._window_start = time.monotonic()
        self._window_successes = 0
        self._window_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        #: transition hook (the registry wires metrics through this)
        self.on_transition = None

    # -- state machine -----------------------------------------------------

    def _transition(self, state: int) -> None:
        """Caller holds the lock."""
        if state == self._state:
            return
        self._state = state
        if state == OPEN:
            self._opened_at = time.monotonic()
        if state in (CLOSED, HALF_OPEN):
            self._probe_inflight = False
        if state == CLOSED:
            self._consecutive_failures = 0
            self._reset_window()
        hook = self.on_transition
        if hook is not None:
            try:
                hook(state)
            except Exception:
                pass  # metrics must never fail the call path

    def _reset_window(self) -> None:
        self._window_start = time.monotonic()
        self._window_successes = 0
        self._window_failures = 0

    def _maybe_roll_window(self) -> None:
        if time.monotonic() - self._window_start > self.window_s:
            self._reset_window()

    def state(self) -> int:
        with self._lock:
            return self._state

    def state_name(self) -> str:
        return _STATE_NAMES[self.state()]

    def allow(self) -> bool:
        """May a call proceed now? OPEN→HALF_OPEN happens here once the
        reset timeout elapses; in HALF_OPEN only ONE probe is admitted at
        a time (a thundering herd against a barely-recovered peer is how
        it goes straight back down)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if time.monotonic() - self._opened_at < self.reset_timeout_s:
                    return False
                self._transition(HALF_OPEN)
            # HALF_OPEN: admit a single probe
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def on_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(CLOSED)
                return
            self._maybe_roll_window()
            self._window_successes += 1
            self._consecutive_failures = 0

    def on_probe_abandoned(self) -> None:
        """The call admitted as the half-open probe ended with NO evidence
        about the peer (the caller's own deadline budget expired before
        the wire was touched): free the slot so the next caller probes,
        instead of wedging HALF_OPEN with a forever-inflight probe."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = False

    def on_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe failed: back to OPEN, reset clock restarted
                self._transition(OPEN)
                return
            if self._state == OPEN:
                return
            self._maybe_roll_window()
            self._window_failures += 1
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.failure_threshold:
                self._transition(OPEN)
                return
            total = self._window_successes + self._window_failures
            if (total >= self.min_throughput
                    and self._window_failures / total >= self.failure_rate):
                self._transition(OPEN)


class BreakerRegistry:
    """Address → breaker, shared by every client pool in a process.

    Metrics: per-target state gauge under scope "rpc.circuitbreaker"
    (metric name = "state:<host>:<port>") plus a cluster-wide transition
    counter — the BENCH-visible record of shed traffic."""

    def __init__(self, metrics=None, **breaker_kwargs) -> None:
        self._lock = threading.Lock()
        self._breakers: Dict[Tuple[str, int], CircuitBreaker] = {}
        self._kwargs = breaker_kwargs
        self.metrics = metrics

    def for_target(self, address: Tuple[str, int]) -> CircuitBreaker:
        key = (str(address[0]), int(address[1]))
        with self._lock:
            breaker = self._breakers.get(key)
            if breaker is None:
                breaker = CircuitBreaker(**self._kwargs)
                breaker.on_transition = self._transition_hook(key)
                self._breakers[key] = breaker
                registry = _resolve(self.metrics)
                if registry is not None:
                    # register the state gauge at creation (CLOSED), so
                    # /metrics shows every target even before a transition
                    registry.gauge(f"rpc.circuitbreaker.{key[0]}:{key[1]}",
                                   "breaker-state", float(CLOSED))
            return breaker

    def _transition_hook(self, key: Tuple[str, int]):
        def hook(state: int) -> None:
            # the black box records every transition even when no
            # registry is wired — breaker flaps around a dead peer are
            # exactly what a post-mortem reconstructs
            flightrecorder.emit(
                "breaker-transition", target=f"{key[0]}:{key[1]}",
                state=_STATE_NAMES.get(state, str(state)))
            registry = _resolve(self.metrics)
            if registry is None:
                return
            # target rides the scope label (prometheus metric names must
            # stay static: cadence_breaker_state{scope="...<host>:<port>"})
            registry.gauge(f"rpc.circuitbreaker.{key[0]}:{key[1]}",
                           "breaker-state", float(state))
            registry.inc("rpc.circuitbreaker", "transitions")
            if state == OPEN:
                registry.inc("rpc.circuitbreaker", "opened")
        return hook

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return {f"{h}:{p}": _STATE_NAMES[b.state()]
                    for (h, p), b in self._breakers.items()}

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()


def _resolve(metrics):
    """None → the process-default registry (mirrors components that fall
    back to metrics.DEFAULT_REGISTRY when unwired)."""
    if metrics is not None:
        return metrics
    from .metrics import DEFAULT_REGISTRY
    return DEFAULT_REGISTRY


#: process-default registry: client pools constructed without explicit
#: wiring (bare RemoteStores in tests/tools) share breaker state per peer
DEFAULT_BREAKERS = BreakerRegistry()
