"""The event-lane layout and the payload row's capacities, as the
reference reads them: a frozen copy of the port's lane indices
(ops/encode.py), its wire32 lanes, and `PayloadLayout` and `PAD`
(core/checksum.py).

A history is packed as [E, 18] int64 lanes, one row an event; a padding
row has event id 0 and event type -1. wire32 carries the same rows as 20
int32 lanes: the two 64-bit lanes (the timestamp and attribute lane 4)
split into their low halves in place and their high halves at the end.
"""
from __future__ import annotations

from dataclasses import dataclass

LANE_EVENT_ID = 0
LANE_EVENT_TYPE = 1
LANE_VERSION = 2
LANE_TIMESTAMP = 3
LANE_TASK_ID = 4
LANE_BATCH_FIRST = 5
LANE_BATCH_LAST = 6
LANE_A0 = 7
NUM_ATTR_LANES = 8
LANE_BRANCH = LANE_A0 + NUM_ATTR_LANES
LANE_PARENT = LANE_BRANCH + 1
LANE_FLAGS = LANE_PARENT + 1
NUM_LANES = LANE_FLAGS + 1  # 18

FLAG_RUN_RESET = 1
FLAG_VH_ONLY = 2

LANE32_TS_HI = NUM_LANES
LANE32_A4_HI = NUM_LANES + 1
NUM_LANES32 = NUM_LANES + 2  # 20
WIDE_LANES = (LANE_TIMESTAMP, LANE_A0 + 4)

#: the pad value of an unused slot of a payload row's lists
PAD = 1 << 62


@dataclass(frozen=True)
class PayloadLayout:
    """Fixed capacities of the canonical payload row."""

    max_version_history_items: int = 8
    max_activities: int = 16
    max_timers: int = 16
    max_children: int = 8
    max_request_cancels: int = 8
    max_signals: int = 8
    max_branches: int = 2

    NUM_SCALARS = 11  # fields before the version-history block

    @property
    def width(self) -> int:
        return (
            self.NUM_SCALARS
            + 1 + 2 * self.max_version_history_items
            + 1 + self.max_timers
            + 1 + self.max_activities
            + 1 + self.max_children
            + 1 + self.max_signals
            + 1 + self.max_request_cancels
        )


DEFAULT_LAYOUT = PayloadLayout()
