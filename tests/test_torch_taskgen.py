"""Task-emitting replay of cadence_tpu_torch on the CPU against the JAX
package's replay_events_with_tasks and the oracle's task streams: all 12
TaskLog tensors and every state tensor equal, exactly (every value is an
integer, so the tolerance is 0), on the five suites and `overflow`, a
lane-level random corpus (wraparound, error rows, `_lex_min3`'s sentinel),
continue-as-new chains and branch trees (VH-only rows), logs of 4 entries
(overflow and counts) and a 30-day retention. The corpora have fixed
(W, E) shapes, shared through module-scoped fixtures, so each JAX program
compiles once."""
import numpy as np
import pytest
import torch

from cadence_tpu.core.enums import EventType as ET
from cadence_tpu.core.events import HistoryBatch, HistoryEvent
from cadence_tpu.gen.corpus import SUITES, generate_corpus, generate_history
from cadence_tpu.ops import encode as j_encode
from cadence_tpu.ops import taskgen as j_taskgen
from cadence_tpu.ops.replay import replay_events_with_tasks as j_replay_tasks
from cadence_tpu_torch.gen import corpus as t_corpus
from cadence_tpu_torch.gen.lanes import random_lanes
from cadence_tpu_torch.oracle.state_builder import StateBuilder
from cadence_tpu_torch.ops import replay as tr
from cadence_tpu_torch.ops import taskgen as t_taskgen
from cadence_tpu_torch.ops.convert import task_log_from_numpy, task_log_to_numpy
from cadence_tpu_torch.ops.encode import to_wire32
from cadence_tpu_torch.ops.state import init_state, leaves
from tests.torch_parity import E_PAD, assert_states_equal, pad_events

SUITE_W = 8  # workflows per suite, as tests/test_taskgen_parity.py generates them
KINDS = list(SUITES) + ["overflow"]


def _log_numpy(log) -> dict:
    return {f: np.asarray(x) for f, x in zip(log._fields, log)}


def assert_logs_equal(port_log, jax_log) -> None:
    """All 12 TaskLog tensors equal, in value and dtype."""
    want = _log_numpy(jax_log)
    got = task_log_to_numpy(port_log)
    assert list(got) == list(want) and len(got) == 12
    bad = [f for f in want if got[f].dtype != want[f].dtype or got[f].shape != want[f].shape
           or not np.array_equal(got[f], want[f])]
    assert not bad, f"task log fields differ from the JAX package: {bad}"


def _both(ev, **kw):
    """(port state, port log, JAX state, JAX log) of one corpus."""
    js, jl = j_replay_tasks(ev, **kw)
    ts, tl = tr.replay_events_with_tasks(ev, device="cpu", **kw)
    return ts, tl, js, jl


def task_streams(log, w):
    """Workflow w's (transfer, timer) tuples, as the oracle streams read."""
    tr_ = [tuple(int(log[f][w, i]) for f in ("tr_type", "tr_version", "tr_event_id"))
           for i in range(int(log["tr_count"][w]))]
    tm = [tuple(int(log[f][w, i]) for f in ("tm_type", "tm_version", "tm_vis", "tm_event_id",
                                             "tm_timeout_type", "tm_attempt"))
          for i in range(int(log["tm_count"][w]))]
    return tr_, tm


def oracle_streams(history):
    ms = StateBuilder().replay_history(history)
    return ([(int(t.task_type), t.version, t.event_id) for t in ms.transfer_tasks],
            [(int(t.task_type), t.version, t.visibility_timestamp, t.event_id,
              int(t.timeout_type), t.attempt) for t in ms.timer_tasks])


# ---------------------------------------------------------------------------
# the suites and `overflow`: one [48, E_PAD] corpus, one JAX compile
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def suites():
    hists = {k: generate_corpus(k, SUITE_W, seed=21, target_events=80) for k in KINDS}
    ev = np.concatenate([pad_events(j_encode.encode_corpus(hists[k])) for k in KINDS])
    return hists, ev, _both(ev)


@pytest.mark.parametrize("kind", KINDS)
def test_suite_task_replay_parity(suites, kind):
    hists, ev, (ts, tl, js, jl) = suites
    assert_states_equal(ts, js)
    assert_logs_equal(tl, jl)
    lo = KINDS.index(kind) * SUITE_W
    log = task_log_to_numpy(tl)
    err = ts.error.numpy()
    port_hists = t_corpus.generate_corpus(kind, SUITE_W, seed=21, target_events=80)
    checked = 0
    for i, h in enumerate(port_hists):
        if err[lo + i] != 0:
            assert kind == "overflow"
            continue
        assert not log["overflow"][lo + i]
        assert task_streams(log, lo + i) == oracle_streams(h), (kind, i)
        checked += 1
    assert checked >= SUITE_W // 2


def test_suite_state_differs_from_plain_replay_only_in_timer_bits(suites):
    """The state a task replay ends in is kernel A's without tasks, except
    the timer-created bits that batch-end task generation sets."""
    _, ev, (ts, _, _, _) = suites
    plain = tr.replay_events(ev, device="cpu")
    differ = {name for (name, a), (_, b) in zip(leaves(ts), leaves(plain))
              if not torch.equal(a, b)}
    assert differ == {"activities.timer_status", "timers.task_status"}


def test_suite_wire32_lanes_give_the_same_tasks(suites):
    _, ev, (ts, tl, _, _) = suites
    W = ev.shape[0]
    s, log = tr.replay_tasks_scan(init_state(W, device="cpu"),
                                  t_taskgen.init_task_log(W, 128, 128, "cpu"),
                                  torch.from_numpy(to_wire32(ev)), wire32=True)
    for (name, a), (_, b) in zip(leaves(s), leaves(ts)):
        assert torch.equal(a, b), name
    for f, a, b in zip(log._fields, log, tl):
        assert torch.equal(a, b), f


# ---------------------------------------------------------------------------
# harder inputs: random lanes, continue-as-new chains, branch trees
# ---------------------------------------------------------------------------


def _signals(first_id, version, n, ts0=1000):
    return [HistoryBatch(domain_id="d", workflow_id="w", run_id="r", events=[
        HistoryEvent(id=first_id + i, event_type=ET.WorkflowExecutionSignaled,
                     version=version, timestamp=ts0 + i) for i in range(n)])]


def _trees():
    """Divergent version-history trees over a timer_retry prefix: a losing
    suffix persisted VH-only, a winning fork, a stale lower fork, a switch
    back to the first branch."""
    out = []
    for i in range(8):
        prefix = generate_history("timer_retry", 5, i, 30)[:2 + i % 3]
        for b in prefix:
            for e in b.events:
                e.version = 2
        nid = prefix[-1].events[-1].id + 1
        shape = i % 4
        if shape == 0:
            segs = [(_signals(nid, 2, 2), 0, 0, True), (_signals(nid, 9, 2), 1, 0, False)]
        elif shape == 1:
            segs = [(_signals(nid, 4, 1), 0, 0, False), (_signals(nid, 3, 1), 1, 0, True)]
        elif shape == 2:
            segs = [(_signals(nid, 5, 2), 1, 0, False), (_signals(nid + 2, 7, 2), 0, 1, False)]
        else:
            segs = [(_signals(nid + k, 3 + k, 1), 1, 0, False) for k in range(3)]
        out.append(j_encode.encode_segments([(prefix, 0, 0, False)] + segs, E_PAD))
    return out


def _chains():
    """Three-run continue-as-new chains of each suite."""
    return [j_encode.encode_chain([generate_history(SUITES[i % 5], 40 + r, i, 30)
                                   for r in range(3)], E_PAD) for i in range(8)]


HARD = {"lanes": slice(0, 64), "chains": slice(64, 72), "trees": slice(72, 80)}


@pytest.fixture(scope="module")
def hard():
    ev = np.concatenate([pad_events(random_lanes(64, 96, 41)), np.stack(_chains()),
                         np.stack(_trees())])
    assert ev.shape == (80, E_PAD, j_encode.NUM_LANES)
    return ev, {}


def _hard_run(hard, key):
    ev, cache = hard
    if key not in cache:
        mt, mm, days = key
        cache[key] = _both(ev, max_transfer=mt, max_timer=mm, retention_days=days)
    return cache[key]


@pytest.mark.parametrize("key", [(128, 128, 1), (4, 4, 1), (128, 128, 30)],
                         ids=["logs128-retention1", "logs4", "retention30"])
def test_hard_corpus_parity(hard, key):
    ts, tl, js, jl = _hard_run(hard, key)
    assert_states_equal(ts, js)
    assert_logs_equal(tl, jl)


def test_hard_corpus_reaches_what_it_pins(hard):
    """The corpus holds error rows, VH-only rows, run resets, overflowing
    logs at 4 entries, and (at 128) timer entries that the sentinel left
    all zero or whose times wrapped below zero."""
    ev, _ = hard
    ts, tl, _, _ = _hard_run(hard, (128, 128, 1))
    err = ts.error.numpy()
    assert (err[HARD["lanes"]] != 0).any() and (err[HARD["chains"]] == 0).all()
    flags = ev[:, :, j_encode.LANE_FLAGS]
    assert (flags[HARD["trees"]] & j_encode.FLAG_VH_ONLY).any()
    assert (flags[HARD["chains"]] & j_encode.FLAG_RUN_RESET).sum() == 16
    log = task_log_to_numpy(tl)
    assert not log["overflow"].any()
    n = log["tm_count"]
    live = np.arange(log["tm_vis"].shape[1])[None, :] < n[:, None]
    timeouts = np.isin(log["tm_type"], (1, 2))  # ActivityTimeout, UserTimer
    zero_entries = live & timeouts & (log["tm_vis"] == 0) & (log["tm_event_id"] == 0)
    assert zero_entries[HARD["lanes"]].any()
    assert (live & (log["tm_vis"] < 0))[HARD["lanes"]].any()
    small = task_log_to_numpy(_hard_run(hard, (4, 4, 1))[1])
    assert small["overflow"].any() and (small["tr_count"] <= 4).all()
    assert (small["tm_count"] <= 4).all()


def test_retention_changes_only_the_deletion_timers(hard):
    _, t1, _, _ = _hard_run(hard, (128, 128, 1))
    _, t30, _, _ = _hard_run(hard, (128, 128, 30))
    a, b = task_log_to_numpy(t1), task_log_to_numpy(t30)
    moved = a["tm_vis"] != b["tm_vis"]
    assert moved.any() and (a["tm_type"][moved] == 4).all()
    assert ((b["tm_vis"] - a["tm_vis"])[moved] == 29 * 86400 * 10**9).all()


def test_chains_against_the_oracle(hard):
    """A chain's log holds its runs' oracle streams one after another: a run
    reset clears the state, not the log."""
    ts, tl, _, _ = _hard_run(hard, (128, 128, 1))
    log = task_log_to_numpy(tl)
    for i in range(8):
        runs = [t_corpus.generate_history(SUITES[i % 5], 40 + r, i, 30) for r in range(3)]
        want_tr, want_tm = [], []
        for run in runs:
            a, b = oracle_streams(run)
            want_tr += a
            want_tm += b
        assert task_streams(log, HARD["chains"].start + i) == (want_tr, want_tm)


def test_overflow_reported_at_small_capacity():
    """tests/test_taskgen_parity.py's case: both logs at 4 entries."""
    ev = j_encode.encode_corpus(generate_corpus("basic", 2, seed=3, target_events=100))
    ts, tl, js, jl = _both(pad_events(ev), max_transfer=4, max_timer=4)
    assert_logs_equal(tl, jl)
    assert tl.overflow.all()


def test_retention_outside_int64_raises_as_jax_does():
    ev = pad_events(np.zeros((2, 0, j_encode.NUM_LANES), dtype=np.int64), 4)
    with pytest.raises(OverflowError):
        j_replay_tasks(ev, retention_days=10**8)
    with pytest.raises(OverflowError):
        tr.replay_events_with_tasks(ev, retention_days=10**8, device="cpu")
    with pytest.raises(OverflowError):
        tr.replay_events_with_tasks(ev, retention_days=-(10**8), device="cpu")


# ---------------------------------------------------------------------------
# _lex_min3, and the kernel's one-pass form of it
# ---------------------------------------------------------------------------

BIG = 1 << 62


def _lex_cases(seed: int, W: int = 256, K: int = 8):
    """Seeded cases: ties on every key, all-invalid rows, keys at and above
    1 << 62, negative times."""
    rng = np.random.default_rng(seed)
    pools = (np.array([-5, -1, 0, 3, 3, 7, BIG - 1, BIG, BIG + 1, (1 << 63) - 1], np.int64),
             np.array([1, 2, 2, 9, BIG, BIG + 5], np.int64),
             np.array([0, 1, 1, 3, BIG + 2], np.int64))
    keys = [p[rng.integers(0, len(p), (W, K))] for p in pools]
    valid = rng.random((W, K)) < rng.choice([0.0, 0.3, 0.8, 1.0], size=(W, 1))
    return valid, keys[0], keys[1], keys[2]


def _lexmin_one_pass(valid, ts, eid, ty):
    """The kernel's LexMin (csrc/taskgen.cuh) written in Python: one pass
    over the valid candidates, then select(). Returns (found, index or -1)."""
    n_valid = n_ts = n_eid = 0
    best = None
    for i in range(len(valid)):
        if not valid[i]:
            continue
        t, e, y = int(ts[i]), int(eid[i]), int(ty[i])
        if n_valid == 0 or t < best[0]:
            best, n_ts, n_eid = [t, e, y, i], 1, 1
        elif t == best[0]:
            n_ts += 1
            if e < best[1]:
                best[1:], n_eid = [e, y, i], 1
            elif e == best[1]:
                n_eid += 1
                if y < best[2] or (y == best[2] and i < best[3]):
                    best[2:] = [y, i]
        n_valid += 1
    if n_valid == 0:
        return False, -1
    C = len(valid)
    if ((n_valid < C and best[0] > BIG) or (n_ts < C and best[1] > BIG)
            or (n_eid < C and best[2] > BIG)):
        return True, -1
    return True, best[3]


@pytest.mark.parametrize("seed", range(3))
def test_lex_min3_against_jax(seed):
    valid, ts, eid, ty = _lex_cases(seed)
    jf, js = (np.asarray(x) for x in j_taskgen._lex_min3(valid, ts, eid, ty))
    tf, tsel = t_taskgen._lex_min3(*(torch.from_numpy(x) for x in (valid, ts, eid, ty)))
    assert np.array_equal(tf.numpy(), jf) and np.array_equal(tsel.numpy(), js)
    # the cases reach the sentinel: found, but nothing selected
    assert (jf & ~js.any(axis=1)).any() and (~jf).any()
    for w in range(len(valid)):
        found, idx = _lexmin_one_pass(valid[w], ts[w], eid[w], ty[w])
        assert found == jf[w]
        assert idx == (int(np.argmax(js[w])) if js[w].any() else -1), w


# ---------------------------------------------------------------------------
# the numpy boundary, and the device rule
# ---------------------------------------------------------------------------


def test_task_log_crosses_from_jax_and_back(suites):
    _, _, (_, tl, _, jl) = suites
    log = task_log_from_numpy(_log_numpy(jl), device="cpu")
    for f, a, b in zip(log._fields, log, tl):
        assert a.dtype == b.dtype and torch.equal(a, b), f
    back = task_log_to_numpy(log)
    assert all(np.array_equal(back[f], v) for f, v in _log_numpy(jl).items())
    bad = dict(_log_numpy(jl))
    bad["tm_vis"] = bad["tm_vis"].astype(np.int32)
    with pytest.raises(ValueError):
        task_log_from_numpy(bad, device="cpu")


def test_no_device_named_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ev = pad_events(np.zeros((2, 0, j_encode.NUM_LANES), dtype=np.int64), 4)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tr.replay_events_with_tasks(ev)
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_taskgen.init_task_log(2, 4, 4)
