"""The port's capacity-escalation ladder and its rungs on the CPU, beside
the JAX package's: the cases of tests/test_ladder.py that need no Stores,
each run through cadence_tpu.engine.ladder.EscalationLadder and
cadence_tpu_torch.engine.ladder.EscalationLadder on the same numpy lanes,
with the rows, CRCs, resolved flags, errors, branches and per-rung row
counts compared exactly, and the resolved rows held to the oracle."""
import random

import numpy as np
import pytest

from cadence_tpu.core.checksum import DEFAULT_LAYOUT, STICKY_ROW_INDEX, crc32_of_row, payload_row
from cadence_tpu.engine.ladder import EscalationLadder as JLadder
from cadence_tpu.gen.corpus import (
    OVERFLOW_FRACTION,
    HistoryWriter,
    gen_overflow,
    generate_corpus,
)
from cadence_tpu.ops import replay as jr
from cadence_tpu.ops.encode import encode_corpus, gather_subcorpus
from cadence_tpu.ops.state import ErrorCode, widen_layout
from cadence_tpu.ops.wirec import pack_wirec
from cadence_tpu.oracle.state_builder import StateBuilder
from cadence_tpu.utils.compile_cache import KernelVariantCache
from cadence_tpu_torch.engine.ladder import EscalationLadder
from cadence_tpu_torch.ops import replay as tr
from cadence_tpu_torch.ops import wirec as tw
from cadence_tpu_torch.utils import metrics as m
from tests.torch_parity import assert_states_equal, wirec_corpus

SEED = 20260730


def _flood_history(capacity_hint: int):
    """One history holding capacity_hint + 8 concurrently pending
    activities mid-replay, drained before close."""
    s = 0
    while random.Random(s).random() >= OVERFLOW_FRACTION:
        s += 1
    rng = random.Random(s)
    w = HistoryWriter(workflow_id="flood", run_id="run-flood")
    gen_overflow(rng, w, target_events=40, capacity_hint=capacity_hint)
    return w.batches


def _oracle_row(history):
    row = payload_row(StateBuilder().replay_history(history))
    row[STICKY_ROW_INDEX] = 0
    return row


def _overflow(n=128, target=80):
    hists = generate_corpus("overflow", num_workflows=n, seed=SEED, target_events=target)
    events = encode_corpus(hists)
    errors = np.asarray(jr.replay_events(events).error)
    return hists, events, np.nonzero(errors)[0]


def _ladders(**kw):
    reg = m.MetricsRegistry()
    return (EscalationLadder(DEFAULT_LAYOUT, registry=reg, device="cpu", **kw),
            JLadder(DEFAULT_LAYOUT, variants=KernelVariantCache(), **kw), reg)


def _same_outcome(got, want):
    for name in ("rows", "resolved", "errors", "branch"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert [(r["rung"], r["rows"]) for r in got.rungs] == \
        [(r["rung"], r["rows"]) for r in want.rungs]


def test_rung1_resolves_default_overflow_suite():
    hists, events, flagged = _overflow(256)
    assert len(flagged) >= 4
    sub = gather_subcorpus(events, flagged)
    port, ref, _ = _ladders()
    got = port.escalate(sub)
    _same_outcome(got, ref.escalate(sub))
    assert got.resolved.all() and [r["rung"] for r in got.rungs] == [1]
    for k, i in enumerate(flagged):
        assert np.array_equal(got.rows[k], _oracle_row(hists[i]))


@pytest.mark.parametrize("factor,rungs,resolved", [(2, [1, 2], True), (4, [1, 2], False)],
                         ids=["rung2-resolves", "top-rung-residual"])
def test_flood_climbs_the_ladder(factor, rungs, resolved):
    """A flood past 2K but under 4K resolves at rung 2; one past the top
    rung stays residual, for the oracle, which still gives a base-width row."""
    hists = [_flood_history(DEFAULT_LAYOUT.max_activities * factor)]
    events = encode_corpus(hists)
    assert np.asarray(jr.replay_events(events).error)[0] == ErrorCode.TABLE_OVERFLOW
    sub = gather_subcorpus(events, [0])
    port, ref, reg = _ladders(max_rungs=2)
    got = port.escalate(sub)
    _same_outcome(got, ref.escalate(sub))
    assert [r["rung"] for r in got.rungs] == rungs
    assert bool(got.resolved[0]) is resolved
    row = _oracle_row(hists[0])
    assert row.shape[0] == DEFAULT_LAYOUT.width
    if resolved:
        assert np.array_equal(got.rows[0], row)
    else:
        assert got.errors[0] == ErrorCode.TABLE_OVERFLOW
        assert reg.counter(m.SCOPE_TPU_FALLBACK, m.M_LADDER_RESIDUAL) == 1


def test_wirec_ladder_crc_parity():
    hists, events, flagged = _overflow()
    corpus = pack_wirec(events)
    port, ref, _ = _ladders()
    crcs, resolved, errors = port.escalate_wirec(tw.pack_wirec(events), flagged)
    want = ref.escalate_wirec(corpus, flagged)
    for g, w in zip((crcs, resolved, errors), want):
        assert g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
    assert [(r["rung"], r["rows"]) for r in port.last_run] == \
        [(r["rung"], r["rows"]) for r in ref.last_run]
    assert resolved.all()
    for k, i in enumerate(flagged):
        assert crcs[k] == np.uint32(crc32_of_row(_oracle_row(hists[i])))


def test_counters_land_in_the_registry_passed():
    _, events, flagged = _overflow()
    port, _, reg = _ladders()
    port.escalate(gather_subcorpus(events, flagged))
    snap = reg.snapshot()[m.SCOPE_TPU_FALLBACK]
    assert snap[m.M_LADDER_FLAGGED] == len(flagged)
    assert snap[m.ladder_rung_rows(1)] == len(flagged)
    assert snap[m.M_LADDER_RESOLVED] == len(flagged)
    assert snap[m.M_LADDER_RESIDUAL] == 0
    assert snap[m.M_PROFILE_FALLBACK + ".count"] == 1
    assert m.SCOPE_TPU_FALLBACK not in m.DEFAULT_REGISTRY.snapshot()


def test_submit_finish_across_chunks():
    """Two chunks' rung-1 launches, then one finish: per-chunk outcomes
    equal the JAX package's."""
    _, events, flagged = _overflow()
    a = gather_subcorpus(events, flagged[:3])
    b = gather_subcorpus(events, flagged[3:])
    port, ref, _ = _ladders()
    got = port.finish([port.submit(a), port.submit(b)])
    want = ref.finish([ref.submit(a), ref.submit(b)])
    for g, w in zip(got, want):
        _same_outcome(g, w)


def test_escalate_states_keeps_the_widened_state():
    hists = [_flood_history(DEFAULT_LAYOUT.max_activities * 2)]
    sub = gather_subcorpus(encode_corpus(hists), [0])
    port, ref, _ = _ladders(max_rungs=2)
    got, states = port.escalate_states(sub)
    want, jstates = ref.escalate_states(sub)
    _same_outcome(got, want)
    s, k = states[0]
    js, jk = jstates[0]
    assert k == jk == 0
    assert_states_equal(s, js)


@pytest.mark.parametrize("kind,factor", [("overflow", 2), ("overflow", 4), ("flood", 2),
                                         ("flood", 4)]
                         + [(k, 2) for k in ("basic", "echo_signal", "timer_retry",
                                             "concurrent_child", "ndc", "lanes")])
def test_replay_escalated_equals_jax(kind, factor):
    """The rungs themselves: replay_escalated and replay_escalated_state
    (the widened state, all 66 tensors) and replay_wirec_escalated_crc, on
    the overflow suite's flagged rows, a flood, the five suites and the
    random lanes."""
    if kind == "flood":
        events = encode_corpus([_flood_history(DEFAULT_LAYOUT.max_activities * 2)])
    elif kind == "overflow":
        _, events, flagged = _overflow()
        events = gather_subcorpus(events, flagged, pad_workflows=16, pad_events=128)
    else:
        events = wirec_corpus(kind)
    layout = widen_layout(DEFAULT_LAYOUT, factor)
    want = jr.replay_escalated(events, layout)
    got = tr.replay_escalated(events, layout, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    js, *_ = jr.replay_escalated_state(events, layout)
    s, rows, _, _ = tr.replay_escalated_state(events, layout, device="cpu")
    assert_states_equal(s, js)
    assert np.array_equal(rows.numpy(), np.asarray(want[0]))
    c = pack_wirec(events)
    wcrc = jr.replay_wirec_escalated_crc(c.slab, c.bases, c.n_events, c.profile, layout)
    gcrc = tr.replay_wirec_escalated_crc(c.slab, c.bases, c.n_events, c.profile, layout,
                                         device="cpu")
    assert np.array_equal(gcrc[0].numpy(), np.asarray(wcrc[0]).astype(np.int64))
    for g, w in zip(gcrc[1:], wcrc[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_ladder_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EscalationLadder(DEFAULT_LAYOUT)


@pytest.mark.parametrize("F,E,want", [(1, 1, (8, 16)), (9, 17, (16, 32)), (64, 128, (64, 128))])
def test_pad_dims_are_the_reference_buckets(F, E, want):
    port, ref, _ = _ladders()
    assert port._pad_dims(F, E) == ref._pad_dims(F, E) == want


@pytest.mark.parametrize("n", [2, 3])
def test_mesh_rungs_equal_mesh_of_1_and_jax(n):
    """Given a mesh, the dense and wirec rungs re-replay sharded (the
    sub-corpus padded to a multiple of the mesh): the same outcome as on
    one device and as the JAX ladder on its mesh of n."""
    import jax

    from cadence_tpu.parallel.mesh import make_mesh
    from cadence_tpu_torch.parallel.mesh import Mesh

    _, events, flagged = _overflow(256)
    sub = gather_subcorpus(events, flagged)
    port = EscalationLadder(DEFAULT_LAYOUT, registry=m.MetricsRegistry(), device="cpu",
                            mesh=Mesh(["cpu"] * n))
    single = EscalationLadder(DEFAULT_LAYOUT, registry=m.MetricsRegistry(), device="cpu")
    ref = JLadder(DEFAULT_LAYOUT, variants=KernelVariantCache(),
                  mesh=make_mesh(jax.devices()[:n]))
    assert port._pad_dims(len(flagged), 40) == ref._pad_dims(len(flagged), 40)
    got = port.escalate(sub)
    _same_outcome(got, ref.escalate(sub))
    _same_outcome(got, single.escalate(sub))
    corpus = pack_wirec(events)
    got_w = port.escalate_wirec(corpus, flagged)
    for g, w, s in zip(got_w, ref.escalate_wirec(corpus, flagged),
                       single.escalate_wirec(corpus, flagged)):
        assert np.array_equal(g, np.asarray(w)) and np.array_equal(g, s)
    assert got_w[1].all()
