"""The plain replay of cadence_tpu_torch (ops/transitions.step scanned over
the events) ends in the same ReplayState as the JAX package's
replay_events, on every one of its 66 tensors, exactly."""
import numpy as np
import pytest

from cadence_tpu.core.enums import EventType as ET
from cadence_tpu.core.events import HistoryBatch, HistoryEvent
from cadence_tpu.gen.corpus import SUITES, HistoryWriter, generate_corpus
from cadence_tpu.gen.fuzz import generate_fuzz_corpus
from cadence_tpu.ops import encode as j_encode
from cadence_tpu.ops.replay import replay_events as j_replay_events
from cadence_tpu_torch.gen.lanes import random_lanes
from cadence_tpu_torch.ops import encode as t_encode
from cadence_tpu_torch.ops.convert import state_from_numpy
from cadence_tpu_torch.ops.replay import replay_events, replay_from_state
from cadence_tpu_torch.ops.state import ErrorCode
from tests.torch_parity import E_PAD, assert_states_equal, jax_state_to_numpy, pad_events

W = 16


def _check(ev: np.ndarray):
    ev = pad_events(ev, E_PAD, W if ev.shape[0] <= W else 64)
    want = j_replay_events(ev)
    got = replay_events(ev, device="cpu")
    assert_states_equal(got, want)
    return got


@pytest.mark.parametrize("suite", list(SUITES) + ["overflow"])
def test_suites(suite):
    n = 64 if suite == "overflow" else W
    ev = j_encode.encode_corpus(generate_corpus(suite, n, seed=11, target_events=100))
    got = _check(ev)
    if suite == "overflow":
        assert (got.error.numpy() == ErrorCode.TABLE_OVERFLOW).any()


@pytest.mark.parametrize("profile", ["mixed", "ndc_conflict", "chain", "child_tree"])
def test_fuzz_corpora(profile):
    hs = generate_fuzz_corpus(W, seed=5, target_events=80, profile=profile)
    ev = j_encode.encode_corpus(hs)
    if ev.shape[1] > E_PAD:
        ev = ev[:, :E_PAD]
    _check(ev)


def _run(close: ET, w=None):
    w = w or HistoryWriter()
    w.begin_batch()
    w.add(ET.WorkflowExecutionStarted, execution_start_to_close_timeout_seconds=60,
          task_start_to_close_timeout_seconds=10)
    w.add(ET.DecisionTaskScheduled, start_to_close_timeout_seconds=10)
    w.end_batch()
    sched = w.next_id - 1
    w.begin_batch()
    started = w.add(ET.DecisionTaskStarted, scheduled_event_id=sched)
    w.end_batch()
    w.begin_batch()
    w.add(ET.DecisionTaskCompleted, scheduled_event_id=sched, started_event_id=started.id)
    w.add(close, **({"new_execution_run_id": "next"}
                    if close == ET.WorkflowExecutionContinuedAsNew else {}))
    w.end_batch()
    return w.batches


def test_continue_as_new_chains():
    """FLAG_RUN_RESET rows: 3-run chains, and a chain whose first run is
    corrupt (the error survives the reset)."""
    runs = [_run(ET.WorkflowExecutionContinuedAsNew) for _ in range(2)]
    runs.append(_run(ET.WorkflowExecutionCompleted))
    rows = [j_encode.encode_chain(runs, E_PAD)]
    assert (rows[0][:, j_encode.LANE_FLAGS] & j_encode.FLAG_RUN_RESET).sum() == 2
    broken = [[HistoryBatch(domain_id="d", workflow_id="w", run_id="r", events=[
        HistoryEvent(id=1, event_type=ET.ActivityTaskStarted, attrs={"scheduled_event_id": 9})])]]
    rows.append(j_encode.encode_chain(broken + runs, E_PAD))
    hs = generate_corpus("ndc", 4, seed=2, target_events=30)
    rows.append(j_encode.encode_chain(hs, E_PAD))
    got = _check(np.stack(rows))
    assert got.error.numpy().tolist()[:2] == [0, ErrorCode.MISSING_ACTIVITY]
    assert np.array_equal(t_encode.encode_chain(runs, E_PAD), rows[0])


def _signals(first_id, version, n=2):
    return [HistoryBatch(domain_id="d", workflow_id="w", run_id="r", events=[
        HistoryEvent(id=first_id + i, event_type=ET.WorkflowExecutionSignaled,
                     version=version, timestamp=1000 + i) for i in range(n)])]


def test_branch_trees():
    """Divergent version-history trees as tests/test_chain_branch.py builds
    them: fork-inherit, FLAG_VH_ONLY, current-branch switch, a stale
    lower-version fork, and a fork with no parent items (BAD_FORK)."""
    w = HistoryWriter()
    w.begin_batch()
    w.add(ET.WorkflowExecutionStarted, execution_start_to_close_timeout_seconds=60,
          task_start_to_close_timeout_seconds=10)
    w.add(ET.DecisionTaskScheduled, start_to_close_timeout_seconds=10)
    w.end_batch()
    prefix = w.batches
    for b in prefix:
        for e in b.events:
            e.version = 1
    nid = prefix[-1].events[-1].id + 1
    trees = [
        [(prefix, 0, 0, False), (_signals(nid, 1), 0, 0, True), (_signals(nid, 12), 1, 0, False)],
        [(prefix, 0, 0, False), (_signals(nid, 6, 1), 0, 0, False),
         (_signals(nid, 5, 1), 1, 0, True)],
        [(prefix, 0, 0, False), (_signals(nid, 3, 3), 1, 0, False),
         (_signals(nid + 3, 4, 2), 0, 1, False)],
        [(_signals(1, 2), 1, 0, False)],
    ]
    ev = np.stack([j_encode.encode_segments(t, E_PAD) for t in trees])
    got = _check(ev)
    assert got.current_branch.numpy().tolist()[:2] == [1, 0]
    assert int(got.error[3]) == ErrorCode.BAD_FORK
    assert np.array_equal(np.stack([t_encode.encode_segments(t, E_PAD) for t in trees]), ev)


@pytest.mark.parametrize("seed", range(4))
def test_random_lanes(seed):
    _check(random_lanes(64, 128, seed))


def test_random_lanes_show_every_error_code():
    seen = set()
    for seed in range(4):
        seen |= set(replay_events(random_lanes(64, 128, seed), device="cpu").error.tolist())
    codes = {v for k, v in vars(ErrorCode).items() if k.isupper()}
    assert codes <= seen, sorted(codes - seen)


@pytest.mark.parametrize("source", ["suite", "lanes"])
def test_from_state_carried_across(source):
    """Replay the first half in JAX, carry the state across as numpy, finish
    in the port: equal to one full JAX replay."""
    if source == "suite":
        ev = pad_events(j_encode.encode_corpus(
            generate_corpus("concurrent_child", W, seed=4, target_events=100)))
    else:
        ev = pad_events(random_lanes(64, 128, 9))
    half = ev.shape[1] // 2
    first = j_replay_events(ev[:, :half])
    carried = state_from_numpy(jax_state_to_numpy(first), device="cpu")
    got = replay_from_state(ev[:, half:], carried, device="cpu")
    assert_states_equal(got, j_replay_events(ev))
    # the carried state is left as it was
    assert_states_equal(carried, first)


# --- the places a transliteration most likely diverges, one lane script each

def _lanes(events):
    """[1, E_PAD, 18] from a list of {lane: value} dicts (ids 1, 2, ...)."""
    ev = np.zeros((1, E_PAD, j_encode.NUM_LANES), dtype=np.int64)
    ev[0, :, j_encode.LANE_EVENT_TYPE] = -1
    for i, fields in enumerate(events):
        row = ev[0, i]
        row[j_encode.LANE_EVENT_ID] = i + 1
        row[j_encode.LANE_BATCH_FIRST] = i + 1
        row[j_encode.LANE_BATCH_LAST] = 1
        row[j_encode.LANE_TIMESTAMP] = 1_000 + i
        for lane, value in fields.items():
            row[lane] = value
    return ev


T, A0, A1, V = (j_encode.LANE_EVENT_TYPE, j_encode.LANE_A0, j_encode.LANE_A0 + 1,
                j_encode.LANE_VERSION)
START = {T: ET.WorkflowExecutionStarted, A0: 60, A1: 10}
DSCHED = {T: ET.DecisionTaskScheduled, A0: 10}


@pytest.mark.parametrize("name,events", [
    ("dfail_reads_pre_step_next_id_and_new_version",
     [START, DSCHED, {T: ET.DecisionTaskStarted, A0: 2},
      {T: ET.DecisionTaskFailed, V: 3}]),
    ("completed_keeps_current_branch_version",
     [START, DSCHED, {T: ET.WorkflowExecutionCompleted, V: 1}, {T: ET.MarkerRecorded, V: 4}]),
    ("match_deletes_every_slot",
     [START, {T: ET.TimerStarted, A0: 5}, {T: ET.TimerStarted, A0: 5},
      {T: ET.TimerStarted, A0: 6}, {T: ET.TimerFired, A0: 5}]),
    ("insert_takes_first_free_slot",
     [START, {T: ET.ActivityTaskScheduled, A0: 1}, {T: ET.ActivityTaskScheduled, A0: 2},
      {T: ET.ActivityTaskScheduled, A0: 3}, {T: ET.ActivityTaskCompleted, A0: 3},
      {T: ET.ActivityTaskScheduled, A0: 4}]),
    ("full_table_overflows",
     [START] + [{T: ET.SignalExternalWorkflowExecutionInitiated}] * 9),
    ("negative_branch_clips_to_zero",
     [START, {T: ET.MarkerRecorded, j_encode.LANE_BRANCH: -1, V: 2}]),
    ("branch_past_capacity_overflows",
     [START, {T: ET.MarkerRecorded, j_encode.LANE_BRANCH: 2}]),
    ("branch_wraps_through_int32",
     [START, {T: ET.MarkerRecorded, j_encode.LANE_BRANCH: 1 << 32}]),
    ("reset_reinitialises_the_row",
     [START, DSCHED, {T: ET.ActivityTaskScheduled, A0: 1},
      {T: ET.WorkflowExecutionStarted, j_encode.LANE_FLAGS: j_encode.FLAG_RUN_RESET, V: 2}]),
    ("error_step_still_commits_version_history",
     [START, {T: ET.ActivityTaskStarted, A0: 77, V: 9, j_encode.LANE_TASK_ID: 5}]),
    ("timer_expiry_wraps",
     [START, {T: ET.TimerStarted, A0: 1, A1: (1 << 62) + 12345}]),
    ("vh_only_updates_history_only",
     [START, {T: ET.WorkflowExecutionSignaled, j_encode.LANE_FLAGS: j_encode.FLAG_VH_ONLY,
              V: 3}]),
])
def test_divergence_points(name, events):
    got = _check(_lanes(events))
    if name == "match_deletes_every_slot":
        assert got.timers.occ.numpy()[0].tolist()[:3] == [False, False, True]
    if name == "insert_takes_first_free_slot":
        assert got.activities.activity_key.numpy()[0, :3].tolist() == [1, 4, 3]
    if name == "branch_past_capacity_overflows":
        assert int(got.error[0]) == ErrorCode.BRANCH_OVERFLOW
    if name == "error_step_still_commits_version_history":
        assert int(got.error[0]) == ErrorCode.MISSING_ACTIVITY
        assert int(got.current_version[0]) == 9 and int(got.last_event_task_id[0]) == 5
