"""The port's DeviceRebuilder on the CPU beside the JAX package's: the same
jobs give equal MutableStates, field by field (timer_task_status,
task_status and history_size included), and equal RebuildStats; the
capacity-flagged jobs go through the escalation ladder as the reference's
do. Also the codec copy (serialize_history byte for byte), the oracle-only
path and the rule that no device named means the card."""
import dataclasses
import enum

import numpy as np
import pytest
import torch

from cadence_tpu.core import codec as j_codec
from cadence_tpu.core.checksum import STICKY_ROW_INDEX, payload_row
from cadence_tpu.engine.rebuild import DeviceRebuilder as JRebuilder
from cadence_tpu.gen.corpus import SUITES, generate_corpus
from cadence_tpu.oracle.state_builder import StateBuilder as JStateBuilder
from cadence_tpu_torch.core import codec as t_codec
from cadence_tpu_torch.engine.rebuild import DeviceRebuilder, RebuildStats
from cadence_tpu_torch.gen import corpus as t_corpus
from cadence_tpu_torch.utils import metrics as m

SEED = 20260730
SUITE_W = 8


def plain(x):
    """A MutableState (or any part of one) as nested dicts and lists, so a
    state of either package compares field by field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, enum.Enum):
        return x.value
    if hasattr(type(x), "__slots__") and not isinstance(x, (int, float, str, bytes)):
        return {s: plain(getattr(x, s)) for s in type(x).__slots__}
    return x


def assert_ms_equal(got, want, what=""):
    g, w = plain(got), plain(want)
    assert sorted(g) == sorted(w)
    bad = [k for k in w if g[k] != w[k]]
    assert not bad, f"{what}: MutableState fields differ from the JAX package: {bad}"


def stats_tuple(stats):
    return stats.device, stats.oracle_fallback, stats.ladder, dict(stats.kernel_errors)


def _both(hists, **kw):
    jr = JRebuilder(**kw)
    want = jr.rebuild([(h, None) for h in hists])
    tr = DeviceRebuilder(device="cpu", **kw)
    got = tr.rebuild([(h, None) for h in hists])
    return got, want, tr, jr


# ---------------------------------------------------------------------------
# the five suites, whole and cut at a reset point (half their batches, so
# activities and timers are still pending): one job list, one chunk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def suites():
    whole = [h for s in SUITES for h in generate_corpus(s, SUITE_W, seed=21, target_events=80)]
    hists = whole + [h[:len(h) // 2] for h in whole]
    return hists, _both(hists)


@pytest.mark.parametrize("suite", SUITES)
def test_suite_states_equal_the_jax_rebuilder(suites, suite):
    hists, (got, want, _, _) = suites
    lo = SUITES.index(suite) * SUITE_W
    for start in (lo, lo + len(hists) // 2):  # whole, then the prefixes
        for i in range(start, start + SUITE_W):
            assert_ms_equal(got[i], want[i], f"{suite} job {i}")


def test_suite_stats_equal_the_jax_rebuilder(suites):
    hists, (got, _, tr, jr) = suites
    assert stats_tuple(tr.stats) == stats_tuple(jr.stats) == (len(hists), 0, 0, {})
    assert set(tr.last_run) == {"device", "hydrate", "ladder"}
    snap = m.DEFAULT_REGISTRY.snapshot()[m.SCOPE_REBUILD]
    for leg in (m.M_PROFILE_PACK, m.M_PROFILE_H2D, m.M_PROFILE_KERNEL, m.M_PROFILE_READBACK):
        assert snap[f"{leg}.count"] >= 1


def test_suite_timer_bits_reach_the_states(suites):
    """The rebuilt states carry the task generator's timer-created bits,
    which the payload row does not cover: the oracle's, on every job (the
    prefixes hold pending activities and timers)."""
    hists, (got, _, _, _) = suites
    seen = 0
    for ms, h in zip(got, hists):
        o = JStateBuilder().replay_history(h)
        for k, a in o.pending_activity_info_ids.items():
            assert ms.pending_activity_info_ids[k].timer_task_status == a.timer_task_status
            seen += a.timer_task_status != 0
        for k, t in o.pending_timer_info_ids.items():
            assert ms.pending_timer_info_ids[k].task_status == t.task_status
            seen += t.task_status != 0
    assert seen


# ---------------------------------------------------------------------------
# overflow x 96 at 32 jobs a chunk: the ladder (tests/test_ladder.py:323)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def overflow():
    hists = generate_corpus("overflow", 96, seed=SEED, target_events=60)
    return hists, _both(hists, chunk_jobs=32)


def test_overflow_rebuild_equals_the_jax_rebuilder(overflow):
    hists, (got, want, tr, jr) = overflow
    for i, (g, w) in enumerate(zip(got, want)):
        assert_ms_equal(g, w, f"overflow job {i}")
    assert stats_tuple(tr.stats) == stats_tuple(jr.stats)
    assert tr.stats.ladder >= 1 and tr.stats.oracle_fallback == 0
    assert tr.stats.device == len(hists)


def test_overflow_rebuild_payloads_equal_the_oracle(overflow):
    hists, (got, _, tr, _) = overflow
    assert [r["rung"] for r in tr.ladder.last_run] == [1]
    for ms, h in zip(got, hists):
        row = payload_row(ms)
        row[STICKY_ROW_INDEX] = 0
        want = payload_row(JStateBuilder().replay_history(h))
        want[STICKY_ROW_INDEX] = 0
        assert (row == want).all()


def test_ladder_rows_keep_the_reference_timer_bits():
    """The JAX ladder's state rung replays WITHOUT tasks, so a state it
    resolves carries timer_task_status 0 where the oracle has the
    creation bit; the payload row does not cover the bit. The port
    reproduces the reference (ROADMAP §C): overflow seed 20260730, job 22
    of 96 (target_events 60), rebuilt from its first 30 batches."""
    pre = generate_corpus("overflow", 96, seed=SEED, target_events=60)[22][:30]
    [got], [want], tr, _ = _both([pre])
    assert_ms_equal(got, want, "ladder prefix")
    assert tr.stats.ladder == 1
    oracle = JStateBuilder().replay_history(pre)
    bits = {k: a.timer_task_status for k, a in oracle.pending_activity_info_ids.items()}
    assert {k for k, v in bits.items() if v} == {18, 19}
    assert all(a.timer_task_status == 0 for a in got.pending_activity_info_ids.values())
    assert (payload_row(got) == payload_row(oracle)).all()


# ---------------------------------------------------------------------------
# the other paths through rebuild()
# ---------------------------------------------------------------------------


def test_on_device_false_gives_the_oracle_states(suites, monkeypatch):
    """An explicit oracle request touches no device, even where none is."""
    hists, _ = suites
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = [(h, None) for h in hists[:6]]
    rb = DeviceRebuilder()
    got = rb.rebuild(jobs, on_device=False)
    want = JRebuilder().rebuild(jobs, on_device=False)
    for g, w in zip(got, want):
        assert_ms_equal(g, w, "oracle path")
    assert stats_tuple(rb.stats) == (0, 6, 0, {})
    assert rb.metrics.gauge_value(m.SCOPE_REBUILD, m.M_FALLBACK_RATE) == 1.0


def test_no_device_named_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rb = DeviceRebuilder()
    with pytest.raises(RuntimeError, match="no CUDA"):
        rb.rebuild([(generate_corpus("basic", 1, seed=1, target_events=20)[0], None)])
    assert stats_tuple(rb.stats) == (0, 0, 0, {})


def test_rebuild_one_and_empty(suites):
    hists, (got, _, _, _) = suites
    rb = DeviceRebuilder(device="cpu")
    assert rb.rebuild([]) == []
    assert_ms_equal(rb.rebuild_one(hists[3]), got[3], "rebuild_one")


def test_kernel_error_rows_go_to_the_oracle_counted():
    """A non-capacity kernel error (an activity completed that was never
    scheduled) is counted under its code and handed to the oracle."""
    from cadence_tpu.core.enums import EventType as ET
    from cadence_tpu.core.events import HistoryBatch, HistoryEvent

    h = generate_corpus("basic", 2, seed=4, target_events=30)
    bad = list(h[1]) + [HistoryBatch(
        domain_id=h[1][0].domain_id, workflow_id=h[1][0].workflow_id, run_id=h[1][0].run_id,
        events=[HistoryEvent(id=h[1][-1].events[-1].id + 1, event_type=ET.ActivityTaskCompleted,
                             attrs={"scheduled_event_id": 999})])]
    jr, tr = JRebuilder(), DeviceRebuilder(device="cpu")
    jobs = [(h[0], None), (bad, None)]
    # the oracle refuses the history too, and both rebuilders raise its error
    with pytest.raises(Exception, match="missing activity info") as want:
        jr.rebuild(jobs)
    with pytest.raises(Exception, match="missing activity info") as got:
        tr.rebuild(jobs)
    assert type(got.value).__name__ == type(want.value).__name__ == "ReplayError"
    assert stats_tuple(tr.stats) == stats_tuple(jr.stats) == (1, 1, 0, {5: 1})


def test_merge_prepass_keeps_job_order():
    pre = {0: "a", 3: "d"}
    assert DeviceRebuilder._merge_prepass(pre, [1, 2], ["b", "c"]) == ["a", "b", "c", "d"]
    assert DeviceRebuilder._merge_prepass({}, [0, 1], ["x", "y"]) == ["x", "y"]


def test_stats_merge():
    a = RebuildStats(device=2, oracle_fallback=1, ladder=1, kernel_errors={10: 1})
    a.merge(RebuildStats(device=3, kernel_errors={10: 2, 5: 1}))
    assert stats_tuple(a) == (5, 1, 1, {10: 3, 5: 1})


def test_chunk_jobs_knob(monkeypatch):
    monkeypatch.setenv("CADENCE_TPU_REBUILD_CHUNK", "7")
    assert DeviceRebuilder(device="cpu").chunk_jobs == 7
    assert DeviceRebuilder(chunk_jobs=3, device="cpu").chunk_jobs == 3
    monkeypatch.delenv("CADENCE_TPU_REBUILD_CHUNK")
    assert DeviceRebuilder(device="cpu").chunk_jobs == JRebuilder().chunk_jobs == 2048


# ---------------------------------------------------------------------------
# core/codec.py: the copy serializes byte for byte as the reference does
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("suite", list(SUITES) + ["overflow"])
def test_serialize_history_byte_identical(suite):
    j_hists = generate_corpus(suite, 4, seed=9, target_events=80)
    t_hists = t_corpus.generate_corpus(suite, 4, seed=9, target_events=80)
    for jh, th in zip(j_hists, t_hists):
        blob = t_codec.serialize_history(th)
        assert blob == j_codec.serialize_history(jh)
        for b in th:
            assert t_codec.serialize_history([b]) == j_codec.serialize_history([b])
        back = t_codec.deserialize_history(blob)
        assert t_codec.serialize_history(back) == blob


def test_history_size_counts_the_last_run_only():
    from cadence_tpu.engine.rebuild import _rebuilt_history_size as j_size
    from cadence_tpu_torch.engine.rebuild import _rebuilt_history_size as t_size

    th = t_corpus.generate_corpus("basic", 2, seed=9, target_events=60)
    jh = generate_corpus("basic", 2, seed=9, target_events=60)
    both = th[0] + th[1]
    assert t_size(both, th[1][0].run_id) == j_size(jh[0] + jh[1], jh[1][0].run_id) > 0
    assert t_size(both, th[1][0].run_id) == sum(
        len(t_codec.serialize_history([b])) for b in th[1])
    assert np.isscalar(t_size(both, "no-such-run")) and t_size(both, "no-such-run") == 0


def test_mesh_of_2_rebuild_equals_mesh_of_1_and_jax(overflow):
    """The rebuilder's chunks fan across a mesh of 2 (25 jobs a chunk, each
    padded to 26 with a no-op row): the same states and stats as on one
    device and as the JAX rebuilder on its mesh of 2."""
    import jax

    from cadence_tpu.parallel.mesh import make_mesh
    from cadence_tpu_torch.parallel.mesh import Mesh

    hists, (got1, _, tr1, _) = overflow
    jobs = [(h, None) for h in hists]
    tr2 = DeviceRebuilder(chunk_jobs=25, mesh=Mesh(["cpu", "cpu"]))
    got2 = tr2.rebuild(jobs)
    jr2 = JRebuilder(chunk_jobs=25, mesh=make_mesh(jax.devices()[:2]))
    want2 = jr2.rebuild(jobs)
    for i, (g, g1, w) in enumerate(zip(got2, got1, want2)):
        assert_ms_equal(g, w, f"mesh-of-2 job {i}")
        assert_ms_equal(g, g1, f"mesh-of-2 against mesh-of-1, job {i}")
    assert stats_tuple(tr2.stats) == stats_tuple(jr2.stats) == stats_tuple(tr1.stats)
    assert tr2.ladder.mesh == Mesh(["cpu", "cpu"])
