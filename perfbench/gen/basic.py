"""bench/load/basic histories as event lanes, made on the device from a seed.

Upstream Cadence's basic stress workflow is a chain of activities, each
link a decision task followed by an activity task. `template` lays out
one such history as [E, 18] int64 lanes, event by event as the port's
corpus generator writes it (cadence_tpu_torch/gen/corpus.py gen_basic and
its HistoryWriter, packed by ops/encode.py): the start batch, links of
six events (decision started; decision completed with the activity
scheduled; activity started; activity completed with the next decision
scheduled) while the next event id is below `target_events - 6`, then the
last decision and the close.

A shard is verified while its workflows run, so each workflow's history
is read as it stands at a cut drawn from the seed: the end of one of the
template's batches from `read_from` of its events to its close. A cut
mid-chain leaves a decision or an activity pending, and the history's
length, next event id and pending lists differ from cut to cut, so the
payloads, and their CRC32s, differ from workflow to workflow. The cuts are
spread evenly over those batch ends in a table of `cut_block` positions;
every block of `cut_block` consecutive workflows holds the table's cuts
once each, in an order drawn from the seed and the block. So every block,
and every chunk of whole blocks, holds the same events under every seed.

`generate` makes any workflows of the corpus by index, in bulk and on
the lanes' device: the template, cut where the seed puts each workflow's
cut (the events after it are padding rows: zero, event type -1), with
each workflow's start time, the gaps between its events and its task ids
drawn from (seed, workflow index, event) by a counter-based hash, as a
shard interleaves many workflows' events. Times and task ids feed kernel
A; the canonical payload carries neither.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..reference.enums import EventType
from ..reference.layout import (
    LANE_A0,
    LANE_BATCH_FIRST,
    LANE_BATCH_LAST,
    LANE_EVENT_ID,
    LANE_EVENT_TYPE,
    LANE_TASK_ID,
    LANE_TIMESTAMP,
    NUM_LANES,
)

#: the port's HistoryWriter epoch (unix nanos), event gap and first task id
EPOCH_NS = 1_700_000_000_000_000_000
GAP_NS = 1_000_000
FIRST_TASK_ID = 1000

#: the seeded draws: starts spread over a day; a gap of 1-50 ms between
#: events; a first task id below 2**24 and steps of 1-64 between a
#: workflow's task ids (other workflows' tasks take the ids between)
START_SPAN_NS = 86_400 * 1_000_000_000
GAP_MIN_NS, GAP_SPAN_NS = 1_000_000, 49_000_000
TASK_SPAN, TASK_STEP_SPAN = 1 << 24, 64
_SALT_START, _SALT_GAP, _SALT_TASK, _SALT_TASK_STEP, _SALT_CUT = 1, 2, 3, 4, 5

_ACTIVITY_TIMEOUTS = (60, 120, 60, 0)  # schedule-to-start, -to-close, start-to-close, heartbeat


def template(target_events: int) -> np.ndarray:
    """[E, 18] int64 lanes of one basic history of about `target_events`
    events, with the writer's own timestamps and task ids."""
    rows: List[List[int]] = []
    batches: List[List[int]] = []

    def add(etype: EventType, *attrs: int) -> int:
        event_id = len(rows) + 1
        a = list(attrs) + [0] * (8 - len(attrs))
        row = [0] * NUM_LANES
        row[LANE_EVENT_ID] = event_id
        row[LANE_EVENT_TYPE] = int(etype)
        row[LANE_TIMESTAMP] = EPOCH_NS + event_id * GAP_NS
        row[LANE_TASK_ID] = FIRST_TASK_ID + event_id
        row[LANE_A0:LANE_A0 + 8] = a
        rows.append(row)
        batches[-1].append(len(rows) - 1)
        return event_id

    def batch(*events) -> List[int]:
        batches.append([])
        return [add(*e) for e in events]

    batch((EventType.WorkflowExecutionStarted, 3600, 10, 0, 0, 0, 0, 0, -1),
          (EventType.DecisionTaskScheduled, 10, 0))
    sched = 2
    activity = 0
    while len(rows) + 1 < target_events - 6:
        (started,) = batch((EventType.DecisionTaskStarted, sched))
        activity += 1
        _, act = batch((EventType.DecisionTaskCompleted, sched, started),
                       (EventType.ActivityTaskScheduled, activity, *_ACTIVITY_TIMEOUTS))
        (act_started,) = batch((EventType.ActivityTaskStarted, act))
        _, sched = batch((EventType.ActivityTaskCompleted, act),
                         (EventType.DecisionTaskScheduled, 10, 0))
    (started,) = batch((EventType.DecisionTaskStarted, sched))
    batch((EventType.DecisionTaskCompleted, sched, started),
          (EventType.WorkflowExecutionCompleted,))

    out = np.asarray(rows, dtype=np.int64)
    for members in batches:
        out[members, LANE_BATCH_FIRST] = out[members[0], LANE_EVENT_ID]
        out[members[-1], LANE_BATCH_LAST] = 1
    return out


def _wrap(x: int) -> int:
    """A Python int as the int64 it wraps to."""
    return (x + (1 << 63)) % (1 << 64) - (1 << 63)


def _draw(seed: int, w: torch.Tensor, event, salt: int, span: int) -> torch.Tensor:
    """A splitmix64-style hash of (seed, workflow, event, salt) in [0, span);
    int64 arithmetic wraps, as it does on either device."""
    z = w * -7046029254386353131 + _wrap(seed * 6364136223846793005 + salt * 1442695040888963407)
    z = z + (event * -4658895280553007687 if torch.is_tensor(event)
             else _wrap(event * -4658895280553007687))
    z = (z ^ (z >> 30)) * -4658895280553007687
    z = (z ^ (z >> 27)) * -7723592293110705685
    z = z ^ (z >> 31)
    return (z & 0x7FFFFFFFFFFFFFFF) % span


def cut_table(tmpl: torch.Tensor, read_from: float, block: int) -> torch.Tensor:
    """[block] int64 history lengths, spread evenly in order over the ends
    of the template's batches that hold `read_from` of its events or more."""
    E = tmpl.shape[0]
    ends = torch.nonzero(tmpl[:, LANE_BATCH_LAST] == 1).flatten() + 1
    ends = ends[ends >= int(np.ceil(read_from * E))]
    pick = torch.arange(block, dtype=torch.int64, device=tmpl.device) * len(ends) // block
    return ends[pick].to(torch.int64)


def lengths(seed: int, workflows: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """[W] int64 history length of each workflow of `workflows`: the cut at
    the workflow's rank, by a hash of (seed, workflow), within its block."""
    block = len(cuts)
    blocks, which = torch.unique(workflows // block, return_inverse=True)
    members = blocks[:, None] * block + torch.arange(block, device=workflows.device)
    keys = _draw(seed, members, 0, _SALT_CUT, 1 << 62)
    order = torch.argsort(keys, dim=1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(block, device=workflows.device).expand_as(order))
    return cuts[rank[which, workflows % block]]


def generate(seed: int, workflows: torch.Tensor, tmpl: torch.Tensor,
             cuts: torch.Tensor) -> torch.Tensor:
    """[W, E, 18] int64 lanes of the corpus workflows with indices
    `workflows` ([W] int64, on the device the lanes are made on), from the
    template `tmpl` ([E, 18] int64 on that device), the cut table `cuts`
    (cut_table) and `seed`."""
    w = workflows.to(torch.int64)
    E = tmpl.shape[0]
    out = tmpl.expand(w.shape[0], E, NUM_LANES).clone()
    e = torch.arange(E, dtype=torch.int64, device=w.device)[None, :]
    wc = w[:, None]
    start = EPOCH_NS + _draw(seed, w, 0, _SALT_START, START_SPAN_NS)
    gaps = GAP_MIN_NS + _draw(seed, wc, e, _SALT_GAP, GAP_SPAN_NS)
    out[:, :, LANE_TIMESTAMP] = start[:, None] + torch.cumsum(gaps, dim=1)
    del gaps
    first_task = FIRST_TASK_ID + _draw(seed, w, 0, _SALT_TASK, TASK_SPAN)
    steps = 1 + _draw(seed, wc, e, _SALT_TASK_STEP, TASK_STEP_SPAN)
    out[:, :, LANE_TASK_ID] = first_task[:, None] + torch.cumsum(steps, dim=1)
    del steps
    pad = e >= lengths(seed, w, cuts)[:, None]
    out.masked_fill_(pad[:, :, None], 0)
    out[:, :, LANE_EVENT_TYPE].masked_fill_(pad, -1)
    return out


class Histories:
    """A configuration's corpus on one device: `histories(seed, workflows)`
    is `generate` with the configuration's template and cut table; every
    chunk of the corpus is whole blocks of `block` workflows."""

    def __init__(self, config: dict, device: torch.device):
        self.template = torch.from_numpy(template(int(config["target_events"]))).to(device)
        self.cuts = cut_table(self.template, float(config["read_from"]), int(config["cut_block"]))
        self.block = len(self.cuts)

    def __call__(self, seed: int, workflows: torch.Tensor) -> torch.Tensor:
        return generate(seed, workflows, self.template, self.cuts)
