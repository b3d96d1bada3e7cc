"""Rate limiting: token buckets over the engine's TimeSource.

Reference: common/tokenbucket/tb.go + common/quotas/ratelimiter.go:43,
the per-domain collection (quotas/collection.go), and the multi-stage
limiter (quotas/multistageratelimiter.go). Built on the injected clock so
tests with a ManualTimeSource get deterministic refill behavior.

Admission control contract (the layer-5 quota seat the frontend sits
behind): `MultiStageRateLimiter.admit(domain)` either returns (the
request was charged against the DOMAIN stage then the GLOBAL stage) or
raises a typed `ServiceBusyError` carrying `retry_after_s` — the
earliest moment a retry could be admitted, derived from the failing
bucket's refill rate — so callers degrade by backing off instead of
hammering. Limits come from live closures (dynamicconfig), so an
operator update to a hot domain's RPS takes effect on the next request
without a restart.
"""
from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

from .clock import RealTimeSource, TimeSource

NANOS = 1_000_000_000


class ServiceBusyError(Exception):
    """Over-limit rejection (types.ServiceBusyError analog).

    Carries `retry_after_s`, the failing bucket's estimate of when one
    token will next be available — clients should back off at least that
    long. Attributes ride `args`, so the exception round-trips through
    pickle across the wire unchanged."""

    def __init__(self, message: str = "over request limit",
                 retry_after_s: float = 0.0, domain: str = "") -> None:
        super().__init__(message, retry_after_s, domain)
        self.message = message
        self.retry_after_s = retry_after_s
        self.domain = domain

    def __str__(self) -> str:
        if self.retry_after_s > 0:
            return f"{self.message} (retry after {self.retry_after_s:.3f}s)"
        return self.message


class TokenBucket:
    """Classic token bucket: `rps` refill rate, `burst` capacity.

    Burst semantics: `burst <= 0` ALIASES to `rps` — i.e. the default
    capacity is one second's worth of tokens, matching the reference's
    `NewDynamicRateLimiter` posture where an unset burst follows the
    rate. Pass an explicit positive `burst` to decouple them. `rps <= 0`
    means UNLIMITED (every consume succeeds, nothing is tracked).

    Clock discipline: refill is computed from the injected `TimeSource`.
    The bucket is safe against NON-MONOTONIC clocks (NTP step-backs,
    manual clocks driven carelessly): a backwards observation neither
    grants tokens nor rewinds `_last` — otherwise the re-elapsed wall
    time would be credited twice when the clock catches back up."""

    def __init__(self, clock: TimeSource, rps: float, burst: float = 0,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._rps = float(rps)
        self._burst = float(burst) if burst > 0 else float(rps)
        self._tokens = self._burst
        self._last = clock.now()
        #: `wait` sleeps through this seam so deterministic tests can
        #: advance a ManualTimeSource instead of blocking a real thread
        self._sleep = sleep

    @property
    def rps(self) -> float:
        return self._rps

    @property
    def burst(self) -> float:
        return self._burst

    def _refill_locked(self) -> None:
        now = self._clock.now()
        if now <= self._last:
            return  # non-monotonic guard: never credit re-elapsed time
        elapsed = (now - self._last) / NANOS
        self._last = now
        self._tokens = min(self._burst, self._tokens + elapsed * self._rps)

    def try_consume(self, n: float = 1.0) -> bool:
        """Consume n tokens iff available right now (RateLimiter.Allow
        analog); never blocks."""
        if self._rps <= 0:
            return True  # unlimited
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    #: historical name — `allow` predates `try_consume`; same contract
    allow = try_consume

    def time_to(self, n: float = 1.0) -> float:
        """Seconds until n tokens COULD be consumed (0.0 when available
        now; +inf when n exceeds burst capacity — it can never be
        granted in one piece). Non-consuming: a reservation estimate the
        caller can sleep on, and the source of ServiceBusyError's
        retry_after_s."""
        if self._rps <= 0:
            return 0.0
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                return 0.0
            if n > self._burst:
                return math.inf
            return (n - self._tokens) / self._rps

    def wait(self, n: float = 1.0, deadline: Optional[int] = None) -> bool:
        """Block until n tokens are consumed or `deadline` (absolute unix
        nanos on the injected clock) would pass first; returns whether
        the tokens were obtained. Built on the TimeSource + the injected
        sleep seam, so ManualTimeSource tests drive it deterministically
        (`sleep=lambda s: clock.advance(int(s * NANOS))`)."""
        while True:
            if self.try_consume(n):
                return True
            need = self.time_to(n)
            if math.isinf(need):
                return False  # n > burst: unsatisfiable, never spin
            if deadline is not None:
                now = self._clock.now()
                if now + need * NANOS > deadline:
                    return False
            # sleep the full deficit: the deficit only shrinks with time,
            # so one sleep per loop is enough (competing consumers may
            # steal the refill — the loop re-checks)
            self._sleep(max(need, 1.0 / NANOS))


#: the shared bucket behind every UNLIMITED (rps <= 0) domain: stateless
#: (every consume short-circuits on rps <= 0), so one instance serves all
_UNLIMITED = TokenBucket(RealTimeSource(), rps=0)


class Collection:
    """Per-domain limiter collection (quotas/collection.go): one bucket
    per domain, built lazily from a LIVE limit closure and rebuilt
    whenever the closure's answer changes — a dynamicconfig update to a
    domain's RPS takes effect on that domain's next request, without a
    restart and without touching other domains' buckets."""

    def __init__(self, clock: TimeSource,
                 rps_for: Callable[[str], float],
                 burst_for: Optional[Callable[[str], float]] = None) -> None:
        self._clock = clock
        self._rps_for = rps_for
        self._burst_for = burst_for or (lambda domain: 0.0)
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        #: domain → (rps, burst) the live closures answered at build time
        self._applied: Dict[str, Tuple[float, float]] = {}

    def bucket(self, domain: str) -> TokenBucket:
        rps = float(self._rps_for(domain) or 0)
        burst = float(self._burst_for(domain) or 0)
        if rps <= 0:
            # unlimited: share one stateless bucket instead of caching an
            # entry per domain NAME — request-supplied names must never
            # grow server memory (a spray of junk domains would otherwise
            # leak a bucket each)
            return _UNLIMITED
        with self._lock:
            b = self._buckets.get(domain)
            if b is None or self._applied.get(domain) != (rps, burst):
                b = TokenBucket(self._clock, rps, burst)
                self._buckets[domain] = b
                self._applied[domain] = (rps, burst)
            return b

    def limited(self, domain: str) -> bool:
        """Whether this domain has a positive configured limit (i.e. its
        bucket is real, not the shared unlimited one)."""
        return float(self._rps_for(domain) or 0) > 0

    def allow(self, domain: str, n: float = 1.0) -> bool:
        return self.bucket(domain).try_consume(n)

    def time_to(self, domain: str, n: float = 1.0) -> float:
        return self.bucket(domain).time_to(n)

    def reset(self) -> None:
        """Drop every bucket (test isolation seam)."""
        with self._lock:
            self._buckets.clear()
            self._applied.clear()


#: every MultiStageRateLimiter constructed in this process — the test
#: isolation seam (`reset_all`), mirroring DEFAULT_BREAKERS/DEFAULT_REGISTRY
_LIMITERS: "weakref.WeakSet[MultiStageRateLimiter]" = weakref.WeakSet()


def reset_all() -> None:
    """Drop every limiter's bucket state in place (components hold their
    limiter by reference, so clearing in place is the only reset that
    reaches them all — same contract as MetricsRegistry.reset)."""
    for limiter in list(_LIMITERS):
        limiter.reset()


class MultiStageRateLimiter:
    """Global + per-domain stages: a request passes only if EVERY stage
    admits it (quotas/multistageratelimiter.go). Limits come from live
    config closures so updates apply without restarts."""

    def __init__(self, clock: TimeSource,
                 global_rps: Callable[[], int],
                 domain_rps: Callable[[str], int],
                 burst: Callable[[], int]) -> None:
        self._clock = clock
        self._burst = burst
        #: domain stage (quotas/collection.go); the global stage rides the
        #: same collection under the reserved "" key (domains are
        #: non-empty strings, so it can never collide)
        self._domains = Collection(
            clock,
            rps_for=lambda d: (global_rps() if d == ""
                               else domain_rps(d)),
            burst_for=lambda d: burst())
        _LIMITERS.add(self)

    def allow(self, domain: str) -> bool:
        # domain stage FIRST: a hot domain's rejections must not drain the
        # global bucket for everyone else (multistageratelimiter.go order)
        if not self._domains.allow(domain):
            return False
        if not self._domains.allow(""):
            return False
        return True

    def retry_after(self, domain: str) -> float:
        """Seconds until BOTH stages could plausibly admit one request —
        the max of the two deficits (non-consuming estimate)."""
        waits = [self._domains.time_to(domain), self._domains.time_to("")]
        finite = [w for w in waits if not math.isinf(w)]
        return max(finite) if finite else 0.0

    def admit(self, domain: str) -> None:
        """allow() or raise the typed shed: ServiceBusyError carrying the
        retry-after estimate (the frontend's admission-control arm)."""
        if not self.allow(domain):
            raise ServiceBusyError(
                f"domain {domain!r} over request limit",
                retry_after_s=round(self.retry_after(domain), 6),
                domain=domain)

    def reset(self) -> None:
        self._domains.reset()


# -- per-host quota knobs over the environment ------------------------------

#: the cross-process quota spec (subprocess clusters inherit it through
#: rpc/cluster.launch env_per_role; rpc/server.ServiceHost applies it to
#: its DynamicConfig at boot):
#:     CADENCE_TPU_QUOTAS="rps=200,burst=50,domain.hot=20,domain.cold=80"
QUOTAS_ENV = "CADENCE_TPU_QUOTAS"


def parse_quota_spec(spec: str) -> Tuple[float, float, Dict[str, float]]:
    """"rps=200,burst=50,domain.hot=20" → (global_rps, burst, {domain:
    rps}). Unknown keys raise — a typo'd spec silently admitting
    everything is worse than failing loudly at boot (same posture as
    chaos.parse_kv_spec)."""
    global_rps, burst = 0.0, 0.0
    domains: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        key = key.strip()
        if not sep:
            raise ValueError(f"malformed knob {part!r} in {spec!r}")
        if key == "rps":
            global_rps = float(value)
        elif key == "burst":
            burst = float(value)
        elif key.startswith("domain."):
            domain = key[len("domain."):]
            if not domain:
                raise ValueError(f"empty domain in {part!r}")
            domains[domain] = float(value)
        else:
            raise ValueError(f"unknown knob {key!r} in {spec!r}")
    return global_rps, burst, domains
