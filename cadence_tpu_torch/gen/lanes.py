"""Lane-level random corpora: [W, E, 18] int64 event lanes made with numpy
from a seed, for holding the replay kernel against its plain version on
paths the valid-history suites never reach.

The lanes are not valid histories. They are shaped so that every branch
of the transition step fires somewhere: event types in [-1, 42] (both
ends unknown), small keys so that table matches, duplicate keys and
misses all happen, version bumps and drops, branches 0..2 with parents
(fork-inherit, BAD_FORK, BRANCH_OVERFLOW), random flag bits including
FLAG_RUN_RESET and FLAG_VH_ONLY, id holes and duplicates, ragged lengths,
and timer arithmetic that wraps int64. Every ErrorCode of ops/state.py
shows up in a corpus of a few hundred rows.
"""
from __future__ import annotations

import numpy as np

from ..core.enums import EventType as ET
from ..ops.encode import (
    FLAG_RUN_RESET,
    FLAG_VH_ONLY,
    LANE_A0,
    LANE_BATCH_FIRST,
    LANE_BATCH_LAST,
    LANE_BRANCH,
    LANE_EVENT_ID,
    LANE_EVENT_TYPE,
    LANE_FLAGS,
    LANE_PARENT,
    LANE_TASK_ID,
    LANE_TIMESTAMP,
    LANE_VERSION,
    NUM_LANES,
)

# event-type weights over the values -1..42 (index = type + 1)
_WEIGHTS = {
    -1: 0.003, 42: 0.003,
    ET.WorkflowExecutionStarted: 0.01,
    ET.WorkflowExecutionCompleted: 0.004, ET.WorkflowExecutionFailed: 0.004,
    ET.WorkflowExecutionTimedOut: 0.004, ET.WorkflowExecutionCanceled: 0.004,
    ET.WorkflowExecutionTerminated: 0.004, ET.WorkflowExecutionContinuedAsNew: 0.004,
    ET.DecisionTaskScheduled: 0.10, ET.DecisionTaskStarted: 0.08,
    ET.DecisionTaskCompleted: 0.06, ET.DecisionTaskTimedOut: 0.02,
    ET.DecisionTaskFailed: 0.02,
    ET.ActivityTaskScheduled: 0.10, ET.ActivityTaskStarted: 0.06,
    ET.ActivityTaskCompleted: 0.02, ET.ActivityTaskFailed: 0.02,
    ET.ActivityTaskTimedOut: 0.02, ET.ActivityTaskCanceled: 0.02,
    ET.ActivityTaskCancelRequested: 0.02, ET.RequestCancelActivityTaskFailed: 0.01,
    ET.TimerStarted: 0.06, ET.TimerFired: 0.03, ET.TimerCanceled: 0.02,
    ET.CancelTimerFailed: 0.01,
    ET.WorkflowExecutionCancelRequested: 0.01,
    ET.RequestCancelExternalWorkflowExecutionInitiated: 0.03,
    ET.RequestCancelExternalWorkflowExecutionFailed: 0.01,
    ET.ExternalWorkflowExecutionCancelRequested: 0.01,
    ET.MarkerRecorded: 0.02, ET.WorkflowExecutionSignaled: 0.04,
    ET.StartChildWorkflowExecutionInitiated: 0.04,
    ET.ChildWorkflowExecutionStarted: 0.02,
    ET.StartChildWorkflowExecutionFailed: 0.006, ET.ChildWorkflowExecutionCompleted: 0.006,
    ET.ChildWorkflowExecutionFailed: 0.006, ET.ChildWorkflowExecutionCanceled: 0.006,
    ET.ChildWorkflowExecutionTimedOut: 0.006, ET.ChildWorkflowExecutionTerminated: 0.006,
    ET.SignalExternalWorkflowExecutionInitiated: 0.03,
    ET.SignalExternalWorkflowExecutionFailed: 0.01,
    ET.ExternalWorkflowExecutionSignaled: 0.01,
    ET.UpsertWorkflowSearchAttributes: 0.01,
}

_ACT_REFS = (ET.ActivityTaskStarted, ET.ActivityTaskCompleted, ET.ActivityTaskFailed,
             ET.ActivityTaskTimedOut, ET.ActivityTaskCanceled)
_CHILD_REFS = (ET.ChildWorkflowExecutionStarted, ET.StartChildWorkflowExecutionFailed,
               ET.ChildWorkflowExecutionCompleted, ET.ChildWorkflowExecutionFailed,
               ET.ChildWorkflowExecutionCanceled, ET.ChildWorkflowExecutionTimedOut,
               ET.ChildWorkflowExecutionTerminated)
_RC_REFS = (ET.RequestCancelExternalWorkflowExecutionFailed,
            ET.ExternalWorkflowExecutionCancelRequested)
_SG_REFS = (ET.SignalExternalWorkflowExecutionFailed, ET.ExternalWorkflowExecutionSignaled)
_KEYED = (ET.ActivityTaskScheduled, ET.ActivityTaskCancelRequested, ET.TimerStarted,
          ET.TimerFired, ET.TimerCanceled)

_RISKY = (-1, 42, ET.WorkflowExecutionStarted, ET.WorkflowExecutionCompleted,
          ET.WorkflowExecutionFailed, ET.WorkflowExecutionTimedOut,
          ET.WorkflowExecutionCanceled, ET.WorkflowExecutionTerminated,
          ET.WorkflowExecutionContinuedAsNew, ET.DecisionTaskStarted,
          ET.DecisionTaskCompleted, ET.TimerFired, ET.TimerCanceled) \
    + _ACT_REFS + _CHILD_REFS + _RC_REFS + _SG_REFS

_RING = 4  # recent insert ids remembered per table, as match keys


def random_lanes(num_workflows: int, num_events: int, seed: int) -> np.ndarray:
    """[W, E, 18] int64 random event lanes, deterministic in `seed`."""
    rng = np.random.default_rng(seed)
    W, E = num_workflows, num_events
    out = np.zeros((W, E, NUM_LANES), dtype=np.int64)
    out[:, :, LANE_EVENT_TYPE] = -1

    base = np.array([_WEIGHTS.get(t, 0.0) for t in range(-1, 43)])
    # per-row emphasis: each row leans on a few event types; "gentle" rows
    # rarely reference or close anything, so they live long enough to fill
    # their tables and version histories (or to end healthy)
    w_row = base[None, :] * rng.lognormal(0.0, 1.0, size=(W, base.size))
    gentle = rng.random(W) < 0.5
    risky = np.isin(np.arange(-1, 43), _RISKY)
    w_row[np.ix_(gentle, risky)] *= 0.02
    cdf = np.cumsum(w_row / w_row.sum(axis=1, keepdims=True), axis=1)

    length = rng.integers(E // 4, E + 1, size=W)
    version = rng.integers(0, 4, size=W)
    p_bump = rng.uniform(0.0, 0.12, size=W)
    branchy = rng.random(W) < 0.25
    ts = 1_700_000_000_000_000_000 + rng.integers(0, 10**9, size=W)
    batch_first = np.ones(W, dtype=np.int64)
    prev_id = np.zeros(W, dtype=np.int64)
    last_dsched = np.zeros(W, dtype=np.int64)
    rings = {name: np.zeros((W, _RING), dtype=np.int64) for name in ("act", "ch", "rc", "sg")}
    rows = np.arange(W)

    def ring_pick(name, use):
        pick = rings[name][rows, rng.integers(0, _RING, size=W)]
        return np.where(use, pick, rng.integers(0, E + 2, size=W))

    for e in range(E):
        live = e < length
        u = rng.random(W)
        etype = (u[:, None] > cdf).sum(axis=1) - 1
        first = e == 0
        etype = np.where(first & (rng.random(W) < 0.5), int(ET.WorkflowExecutionStarted), etype)

        ev_id = np.full(W, e + 1, dtype=np.int64)
        ev_id = np.where(rng.random(W) < 0.004, prev_id, ev_id)      # duplicate id
        ev_id = np.where(rng.random(W) < 0.01, 0, ev_id)             # hole
        ev_id = np.where(live, ev_id, 0)

        version = version + (rng.random(W) < p_bump)
        version = version - (rng.random(W) < 0.003)                  # a drop
        ts = ts + rng.integers(0, 5 * 10**9, size=W)

        a = rng.integers(0, 6, size=(W, 8))
        match = rng.random(W) < 0.85
        a[:, 0] = np.where(np.isin(etype, _KEYED), rng.integers(1, 7, size=W), a[:, 0])
        a[:, 0] = np.where(np.isin(etype, _ACT_REFS), ring_pick("act", match), a[:, 0])
        a[:, 0] = np.where(np.isin(etype, _CHILD_REFS), ring_pick("ch", match), a[:, 0])
        a[:, 0] = np.where(np.isin(etype, _RC_REFS), ring_pick("rc", match), a[:, 0])
        a[:, 0] = np.where(np.isin(etype, _SG_REFS), ring_pick("sg", match), a[:, 0])
        dstart = etype == ET.DecisionTaskStarted
        a[:, 0] = np.where(dstart, np.where(match, last_dsched, a[:, 0]), a[:, 0])
        a[:, 0] = np.where(etype == ET.DecisionTaskTimedOut, rng.integers(0, 4, size=W), a[:, 0])
        a[:, 1] = np.where(etype == ET.DecisionTaskCompleted, ev_id - 1, a[:, 1])
        big = rng.random(W) < 0.05                                   # wraps ts + a1 * 1e9
        a[:, 1] = np.where((etype == ET.TimerStarted) & big,
                           rng.integers(1 << 40, 1 << 62, size=W), a[:, 1])
        started = etype == ET.WorkflowExecutionStarted
        a[:, 2] = np.where(started, rng.integers(0, 2, size=W) * rng.integers(1, 60, size=W),
                           a[:, 2])
        a[:, 7] = np.where(started, rng.integers(-1, 4, size=W), a[:, 7])
        a[:, 4] = np.where(started & (rng.random(W) < 0.5), ts + 10**12, a[:, 4])

        branch = np.where(branchy, rng.choice(3, size=W, p=[0.8, 0.18, 0.02]), 0)
        parent = np.where(branchy, rng.choice(3, size=W, p=[0.7, 0.25, 0.05]), 0)
        flags = ((rng.random(W) < 0.01) * FLAG_RUN_RESET
                 | (branchy & (rng.random(W) < 0.08)) * FLAG_VH_ONLY
                 | (rng.random(W) < 0.05) * 4)

        last = rng.random(W) < 0.5
        lane = out[:, e]
        lane[:, LANE_EVENT_ID] = ev_id
        lane[:, LANE_EVENT_TYPE] = np.where(live, etype, -1)
        lane[:, LANE_VERSION] = version
        lane[:, LANE_TIMESTAMP] = ts
        lane[:, LANE_TASK_ID] = rng.integers(0, 1 << 20, size=W)
        lane[:, LANE_BATCH_FIRST] = batch_first
        lane[:, LANE_BATCH_LAST] = last
        lane[:, LANE_A0:LANE_A0 + 8] = a
        lane[:, LANE_BRANCH] = branch
        lane[:, LANE_PARENT] = parent
        lane[:, LANE_FLAGS] = flags
        out[~live, e] = 0
        out[~live, e, LANE_EVENT_TYPE] = -1

        for name, t in (("act", ET.ActivityTaskScheduled),
                        ("ch", ET.StartChildWorkflowExecutionInitiated),
                        ("rc", ET.RequestCancelExternalWorkflowExecutionInitiated),
                        ("sg", ET.SignalExternalWorkflowExecutionInitiated)):
            hit = live & (etype == t)
            rings[name][hit, e % _RING] = ev_id[hit]
        last_dsched = np.where(live & (etype == ET.DecisionTaskScheduled), ev_id, last_dsched)
        batch_first = np.where(last, e + 2, batch_first)
        prev_id = np.where(ev_id > 0, ev_id, prev_id)
    return out


#: trap_corpus's row kinds, in the order rows cycle through them
TRAP_KINDS = ("full_tables", "duplicate_keys", "run_reset", "fork", "sticky_error",
              "history_at_kv")

#: the tables, as (state prefix, key field, insert type, the lookups that
#: close a key), as trap_corpus uses them
_TRAP_TABLES = (
    ("activities", "schedule_id", ET.ActivityTaskScheduled, ET.ActivityTaskCompleted),
    ("timers", "timer_key", ET.TimerStarted, ET.TimerFired),
    ("children", "initiated_id", ET.StartChildWorkflowExecutionInitiated,
     ET.ChildWorkflowExecutionCompleted),
    ("cancels", "initiated_id", ET.RequestCancelExternalWorkflowExecutionInitiated,
     ET.RequestCancelExternalWorkflowExecutionFailed),
    ("signals", "initiated_id", ET.SignalExternalWorkflowExecutionInitiated,
     ET.SignalExternalWorkflowExecutionFailed),
)


def trap_corpus(num_workflows: int, num_events: int, seed: int, layout=None):
    """(carried state as {dotted field path: array}, [W, E, 18] int64 lanes):
    the corner cases of kernel A's table and version-history storage,
    deterministic in `seed`. Row i is of kind TRAP_KINDS[i % 6]:
    - full_tables: every table full, or full but its last slot; the lanes
      insert into one table (the last slot, then TABLE_OVERFLOW);
    - duplicate_keys: two slots of each table share a key (the activities
      also an activity key); the lanes start, cancel-request and close them
      (each lookup selects both), then insert into the freed slots;
    - run_reset: occupied tables, a FLAG_RUN_RESET event in the middle of the
      lanes, then inserts and lookups of keys from before and after it;
    - fork: branch 0 (or 1) holds a history and the other none; the lanes
      fork-inherit it (or fail with BAD_FORK from an empty parent) and
      switch the current branch;
    - sticky_error: a row whose error is already set, under lanes that would
      change it;
    - history_at_kv: the current branch's history holds Kv items; the lanes
      update its last item, then overflow it.
    The events' ids continue the carried history; versions never drop."""
    import torch

    from ..core.checksum import DEFAULT_LAYOUT
    from ..ops.convert import state_to_numpy
    from ..ops.state import init_state

    L = layout or DEFAULT_LAYOUT
    rng = np.random.default_rng(seed)
    W, E = num_workflows, num_events
    with torch.no_grad():
        st = state_to_numpy(init_state(W, L, "cpu"))
    B, Kv = L.max_branches, L.max_version_history_items
    caps = {"activities": L.max_activities, "timers": L.max_timers,
            "children": L.max_children, "cancels": L.max_request_cancels,
            "signals": L.max_signals}
    lanes = np.zeros((W, E, NUM_LANES), dtype=np.int64)
    lanes[:, :, LANE_EVENT_TYPE] = -1

    def occupy(i, table, slot, key, akey=None):
        st[f"{table}.occ"][i, slot] = True
        for f in (f for f in st if f.startswith(table + ".") and st[f].dtype == np.int64):
            st[f][i, slot] = rng.integers(1, 1000)
        st[f"{table}.{dict((t, k) for t, k, _, _ in _TRAP_TABLES)[table]}"][i, slot] = key
        if table == "activities":
            st["activities.activity_key"][i, slot] = key if akey is None else akey
            st["activities.started_id"][i, slot] = -23  # EMPTY_EVENT_ID: not started

    for i in range(W):
        kind = TRAP_KINDS[i % len(TRAP_KINDS)]
        # a carried branch-0 history: ids 1, 3, 5, ..., versions nondecreasing
        n0 = int(rng.integers(1, Kv))
        cb = 0
        if kind == "history_at_kv":
            n0 = Kv
            cb = int(rng.integers(0, B))
        if kind == "fork" and B > 1 and rng.random() < 0.5:
            cb = 1  # the history lives on branch 1, branch 0 is empty
        ids = 1 + 2 * np.arange(n0)
        vers = np.maximum.accumulate(rng.integers(1, 4, size=n0))
        st["vh_event_ids"][i, cb, :n0] = ids
        st["vh_versions"][i, cb, :n0] = vers
        st["vh_count"][i, cb] = n0
        st["current_branch"][i] = cb
        st["state"][i] = 1  # Running
        st["next_event_id"][i] = int(ids[-1]) + 1
        v = int(vers[-1])
        next_id = int(ids[-1]) + 1
        events = []  # (type, a0, a1, branch, parent, flags, version)

        def ev(etype, a0=0, a1=0, branch=cb, parent=cb, flags=0, version=None):
            events.append((int(etype), a0, a1, branch, parent, flags,
                           v if version is None else version))

        if kind == "full_tables":
            table, _, ins, _ = _TRAP_TABLES[int(rng.integers(0, len(_TRAP_TABLES)))]
            k = caps[table]
            for t, _, _, _ in _TRAP_TABLES:
                for s in range(caps[t]):
                    occupy(i, t, s, int(rng.integers(1, 1 << 30)))
            if rng.random() < 0.5:  # full but the last slot
                st[f"{table}.occ"][i, k - 1] = False
            ev(ET.WorkflowExecutionSignaled)
            for _ in range(3):
                ev(ins, int(rng.integers(1, 100)), int(rng.integers(1, 100)))
        elif kind == "duplicate_keys":
            keys = {}
            for t, _, _, _ in _TRAP_TABLES:
                slots = rng.choice(caps[t], size=min(caps[t], 4), replace=False)
                keys[t] = int(rng.integers(1, 1 << 30))
                akey = int(rng.integers(1, 7))
                for j, s in enumerate(slots):
                    key = keys[t] if j < 2 else int(rng.integers(1, 1 << 30))
                    occupy(i, t, int(s), key, akey if j < 2 else akey + 10)
                keys[t + ".akey"] = akey
            ev(ET.ActivityTaskCancelRequested, keys["activities.akey"])
            ev(ET.ActivityTaskStarted, keys["activities"])
            ev(ET.ActivityTaskCompleted, keys["activities"])
            ev(ET.TimerFired, keys["timers"])
            ev(ET.ChildWorkflowExecutionStarted, keys["children"])
            ev(ET.ChildWorkflowExecutionCompleted, keys["children"])
            ev(ET.RequestCancelExternalWorkflowExecutionFailed, keys["cancels"])
            ev(ET.SignalExternalWorkflowExecutionFailed, keys["signals"])
            for _, _, ins, _ in _TRAP_TABLES:
                ev(ins, int(rng.integers(1, 7)), int(rng.integers(1, 100)))
        elif kind == "run_reset":
            old = {}
            for t, _, _, _ in _TRAP_TABLES:
                for s in rng.choice(caps[t], size=min(caps[t], 3), replace=False):
                    old[t] = int(rng.integers(1, 1 << 30))
                    occupy(i, t, int(s), old[t])
            ev(ET.ActivityTaskStarted, old["activities"])
            ev(ET.TimerStarted, 5, 60)
            at = int(rng.integers(2, max(3, E // 2)))
            while len(events) < at:
                ev(ET.WorkflowExecutionSignaled)
            # the new run: ids restart at 1 on an empty history
            events.append((int(ET.WorkflowExecutionStarted), 0, 0, 0, 0, FLAG_RUN_RESET, v))
            ev(ET.ActivityTaskScheduled, 3, 9, branch=0, parent=0)
            ev(ET.TimerStarted, 5, 60, branch=0, parent=0)
            if rng.random() < 0.5:  # a key from before the reset is gone
                table, _, _, close = _TRAP_TABLES[int(rng.integers(0, len(_TRAP_TABLES)))]
                ev(close, old[table], branch=0, parent=0)
            else:
                ev(ET.TimerFired, 5, branch=0, parent=0)
        elif kind == "fork":
            other = 1 - cb if B > 1 else cb
            empty_parent = rng.random() < 0.2
            ev(ET.WorkflowExecutionSignaled)
            ev(ET.WorkflowExecutionSignaled, branch=other, parent=other if empty_parent else cb,
               version=v + 1)
            ev(ET.WorkflowExecutionSignaled, branch=other, parent=cb, version=v + 2)
            ev(ET.ActivityTaskScheduled, 4, 4, branch=other, parent=cb, version=v + 2)
            ev(ET.WorkflowExecutionSignaled, branch=cb, parent=cb, version=v + 3)
        elif kind == "sticky_error":
            st["error"][i] = int(rng.integers(1, 15))
            for t, _, ins, _ in _TRAP_TABLES:
                ev(ins, 2, 2)
            ev(ET.WorkflowExecutionSignaled, version=v + 1)
        else:  # history_at_kv
            ev(ET.WorkflowExecutionSignaled)           # the same version: updates the last item
            ev(ET.ActivityTaskScheduled, 1, 1)
            ev(ET.WorkflowExecutionSignaled, version=v + 1)  # a new item: VERSION_HISTORY_OVERFLOW
        # the rest of the lanes: signals on the first event's branch, at the
        # highest version used
        top = max(e[6] for e in events)
        while len(events) < E:
            ev(ET.WorkflowExecutionSignaled, version=top)
        ts = 1_700_000_000_000_000_000 + int(rng.integers(0, 10**9))
        for e, (etype, a0, a1, branch, parent, flags, version) in enumerate(events[:E]):
            if flags & FLAG_RUN_RESET:
                next_id = 1
            row = lanes[i, e]
            row[LANE_EVENT_ID] = next_id
            row[LANE_EVENT_TYPE] = etype
            row[LANE_VERSION] = version
            row[LANE_TIMESTAMP] = ts + e * 1_000_000_000
            row[LANE_TASK_ID] = 1000 + e
            row[LANE_BATCH_FIRST] = next_id
            row[LANE_BATCH_LAST] = 1
            row[LANE_A0] = a0
            row[LANE_A0 + 1] = a1
            row[LANE_BRANCH] = branch
            row[LANE_PARENT] = parent
            row[LANE_FLAGS] = flags
            next_id += 1
    return st, lanes
