"""Mockable time source.

Reference analog: common/clock/time_source.go — the engine never reads the
wall clock directly, so tests and deterministic replays can drive time.
Times are unix nanoseconds (int), matching event timestamps.
"""
from __future__ import annotations

import time


class TimeSource:
    def now(self) -> int:
        raise NotImplementedError


class RealTimeSource(TimeSource):
    def now(self) -> int:
        return time.time_ns()


class ManualTimeSource(TimeSource):
    """Test clock advanced explicitly (clock.NewMockedTimeSource analog)."""

    def __init__(self, start: int = 1_700_000_000_000_000_000) -> None:
        self._now = start

    def now(self) -> int:
        return self._now

    def advance(self, nanos: int) -> int:
        self._now += nanos
        return self._now

    def advance_to(self, ts: int) -> None:
        if ts > self._now:
            self._now = ts
