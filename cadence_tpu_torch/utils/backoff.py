"""Retry backoff + cron schedule math.

Reference:
- activity retry interval: service/history/execution/retry.go:31-80
  (getBackoffInterval — exponential with cap, total-attempt limit,
  expiration cut-off, non-retriable reasons);
- client retry policies:   common/backoff/retrypolicy.go
  (ExponentialRetryPolicy — exponential with jitter, expiration
  interval, attempt cap; wrapped around every service client);
- cron continuation:      common/backoff/cron.go:48
  (GetBackoffForNextSchedule — next standard-cron fire time at or after
  the close time, measured from the close time, rounded up to seconds).

The cron parser implements standard 5-field cron (minute hour day-of-month
month day-of-week) with *, */step, ranges, lists — the subset
robfig/cron.ParseStandard accepts minus macros and time zones.
"""
from __future__ import annotations

import math
import random
from datetime import datetime, timedelta, timezone
from typing import List, Optional, Sequence

NANOS_PER_SECOND = 1_000_000_000

#: sentinel: no retry / no next cron run (backoff.NoBackoff)
NO_BACKOFF = -1


def get_backoff_interval(now_nanos: int, expiration_time_nanos: int,
                         curr_attempt: int, max_attempts: int,
                         init_interval_seconds: int,
                         max_interval_seconds: int,
                         backoff_coefficient: float,
                         failure_reason: str,
                         non_retriable_errors: Sequence[str]
                         ) -> int:
    """Next retry interval in NANOS, or NO_BACKOFF (retry.go:31-80)."""
    if max_attempts == 0 and expiration_time_nanos == 0:
        return NO_BACKOFF
    if max_attempts > 0 and curr_attempt >= max_attempts - 1:
        # currAttempt starts from 0; MaximumAttempts counts the initial try
        return NO_BACKOFF

    try:
        next_interval = int(float(init_interval_seconds)
                            * math.pow(backoff_coefficient, float(curr_attempt)))
    except OverflowError:
        next_interval = 0
    if next_interval <= 0:
        # math.Pow() could overflow
        if max_interval_seconds > 0:
            next_interval = max_interval_seconds
        else:
            return NO_BACKOFF
    if max_interval_seconds > 0 and next_interval > max_interval_seconds:
        next_interval = max_interval_seconds

    backoff_nanos = next_interval * NANOS_PER_SECOND
    if expiration_time_nanos != 0 and now_nanos + backoff_nanos > expiration_time_nanos:
        return NO_BACKOFF
    if failure_reason in non_retriable_errors:
        return NO_BACKOFF
    return backoff_nanos


# ---------------------------------------------------------------------------
# Client retry policy (common/backoff/retrypolicy.go semantics)
# ---------------------------------------------------------------------------


class RetryPolicy:
    """Exponential backoff with FULL jitter for cross-process clients.

    `get_backoff_interval` above is the ACTIVITY retry policy (persisted,
    deterministic, second-granularity); this is the in-memory CLIENT
    policy the reference wraps every service/persistence client in
    (common/backoff ExponentialRetryPolicy + ConcurrentRetrier):

    - interval_i = init * coefficient^i, capped at max_interval;
    - full jitter: the actual sleep is uniform in [0, interval_i]
      (de-synchronizes retry storms across callers);
    - stop when attempts exceed max_attempts, or when the NEXT sleep
      would land past expiration_s of total elapsed time — the same
      cut-off shape as get_backoff_interval's expiration check;
    - NO_BACKOFF (-1) signals "stop retrying".

    Seedable for reproducible tests; thread-safe (the RNG is the only
    shared state and random.Random is internally locked).
    """

    def __init__(self, init_interval_s: float = 0.05,
                 max_interval_s: float = 2.0,
                 backoff_coefficient: float = 2.0,
                 max_attempts: int = 5,
                 expiration_s: float = 0.0,
                 seed: Optional[int] = None) -> None:
        if init_interval_s <= 0:
            raise ValueError("init_interval_s must be > 0")
        if backoff_coefficient < 1.0:
            raise ValueError("backoff_coefficient must be >= 1.0")
        self.init_interval_s = init_interval_s
        self.max_interval_s = max_interval_s
        self.backoff_coefficient = backoff_coefficient
        self.max_attempts = max_attempts
        self.expiration_s = expiration_s
        self._rng = random.Random(seed)

    def next_interval(self, attempt: int, elapsed_s: float) -> float:
        """Jittered sleep before retry number `attempt` (0-based count of
        FAILED tries so far), or NO_BACKOFF to stop.

        max_attempts counts the initial try (retry.go:38 semantics): a
        policy with max_attempts=3 sleeps at most twice."""
        if self.max_attempts > 0 and attempt >= self.max_attempts - 1:
            return NO_BACKOFF
        try:
            interval = (self.init_interval_s
                        * math.pow(self.backoff_coefficient, float(attempt)))
        except OverflowError:
            interval = 0.0
        if interval <= 0 or not math.isfinite(interval):
            # pow overflow: fall to the cap, or stop if there is none
            if self.max_interval_s > 0:
                interval = self.max_interval_s
            else:
                return NO_BACKOFF
        if self.max_interval_s > 0:
            interval = min(interval, self.max_interval_s)
        if (self.expiration_s > 0
                and elapsed_s + interval > self.expiration_s):
            return NO_BACKOFF
        return self._rng.uniform(0.0, interval)


# ---------------------------------------------------------------------------
# Standard cron (minute-granularity), cron.go:48 semantics
# ---------------------------------------------------------------------------


class CronField:
    """One parsed cron field: the set of allowed values."""

    __slots__ = ("allowed",)

    def __init__(self, spec: str, lo: int, hi: int) -> None:
        allowed = set()
        for part in spec.split(","):
            step = 1
            has_step = False
            if "/" in part:
                part, step_s = part.split("/", 1)
                step = int(step_s)
                has_step = True
                if step <= 0:
                    raise ValueError(f"bad cron step {step_s}")
            if part == "*" or part == "?":
                lo_p, hi_p = lo, hi
            elif "-" in part:
                a, b = part.split("-", 1)
                lo_p, hi_p = int(a), int(b)
            else:
                lo_p = int(part)
                # "N/step" means from N to the field maximum by step
                hi_p = hi if has_step else lo_p
            if lo_p < lo or hi_p > hi or lo_p > hi_p:
                raise ValueError(f"cron value out of range: {part} not in [{lo},{hi}]")
            allowed.update(range(lo_p, hi_p + 1, step))
        self.allowed = frozenset(allowed)

    def match(self, value: int) -> bool:
        return value in self.allowed


def _has_star_bit(spec: str) -> bool:
    """True when any comma part's range (before an optional '/step') is
    '*'/'?' — robfig/cron's starBit, OR'd across parts."""
    return any(part.split("/", 1)[0] in ("*", "?") for part in spec.split(","))


class CronSchedule:
    """Parsed 5-field standard cron expression."""

    def __init__(self, spec: str) -> None:
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"cron spec needs 5 fields, got {len(fields)}: {spec!r}")
        self.minute = CronField(fields[0], 0, 59)
        self.hour = CronField(fields[1], 0, 23)
        self.dom = CronField(fields[2], 1, 31)
        self.month = CronField(fields[3], 1, 12)
        # cron day-of-week: 0-6, 0 == Sunday (7 accepted as a Sunday alias)
        self.dow = CronField(fields[4], 0, 7)
        #: dom/dow OR-semantics apply when both are restricted (std cron).
        #: robfig/cron sets the star bit for any part whose base range is
        #: '*' or '?' — including '*/n' — so those count as unrestricted too
        self.dom_star = _has_star_bit(fields[2])
        self.dow_star = _has_star_bit(fields[4])

    def _day_match(self, t: datetime) -> bool:
        dom_ok = self.dom.match(t.day)
        cron_dow = (t.weekday() + 1) % 7  # python Mon=0 → cron Sun=0
        dow_ok = self.dow.match(cron_dow) or (cron_dow == 0 and self.dow.match(7))
        # robfig/cron v1.2.0 dayMatches (the version the reference pins):
        # AND the two day fields when either carries the star bit — which
        # v1.2.0 keeps for '*/n' — OR them when both are restricted.
        # (cron v3 clears the bit for step>1; not the pinned behavior.)
        if self.dom_star or self.dow_star:
            return dom_ok and dow_ok
        return dom_ok or dow_ok

    def next_after(self, t: datetime) -> Optional[datetime]:
        """Earliest fire time strictly after t (cron.Schedule.Next)."""
        cur = (t.replace(second=0, microsecond=0) + timedelta(minutes=1))
        limit = t + timedelta(days=4 * 366)  # robfig's ~4-year give-up bound
        while cur <= limit:
            if not self.month.match(cur.month):
                cur = (cur.replace(day=1, hour=0, minute=0)
                       + timedelta(days=32)).replace(day=1)
                continue
            if not self._day_match(cur):
                cur = cur.replace(hour=0, minute=0) + timedelta(days=1)
                continue
            if not self.hour.match(cur.hour):
                cur = cur.replace(minute=0) + timedelta(hours=1)
                continue
            if not self.minute.match(cur.minute):
                cur += timedelta(minutes=1)
                continue
            return cur
        return None


def validate_cron_schedule(spec: str) -> bool:
    """ValidateSchedule analog (cron.go:37): empty means "no cron"."""
    if spec == "":
        return True
    try:
        CronSchedule(spec)
        return True
    except (ValueError, IndexError):
        return False


def get_backoff_for_next_schedule(cron_schedule: str, start_nanos: int,
                                  close_nanos: int) -> int:
    """Seconds until the next cron run measured from close time, or
    NO_BACKOFF (cron.go:48 GetBackoffForNextScheduleInSeconds)."""
    if not cron_schedule:
        return NO_BACKOFF
    try:
        schedule = CronSchedule(cron_schedule)
    except (ValueError, IndexError):
        return NO_BACKOFF
    start = datetime.fromtimestamp(start_nanos / NANOS_PER_SECOND, tz=timezone.utc)
    close = datetime.fromtimestamp(close_nanos / NANOS_PER_SECOND, tz=timezone.utc)
    nxt = schedule.next_after(start)
    while nxt is not None and nxt < close:
        nxt = schedule.next_after(nxt)
    if nxt is None:
        return NO_BACKOFF
    backoff_seconds = (nxt - close).total_seconds()
    return int(math.ceil(backoff_seconds))
