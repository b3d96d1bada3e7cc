"""The port's bulk verify engine (cadence_tpu_torch/engine/tpu_engine.py
TPUReplayEngine) on the CPU beside the JAX package's, on Stores built
from the same seeded corpora (each package generating with its own
gen/corpus.py and building its live states with its own oracle):
verify_all's total, verified_on_device and its divergent, fallback,
device_errors and escalated lists, order included, and
replay_tree_payloads' rows, errors and branches, exactly.

The JAX side runs with CADENCE_TPU_RESIDENT=0, the configuration the
port implements until its resident slice; one case holds a fresh JAX
engine at its default setting to the port on a first call."""
import copy
import random

import jax
import numpy as np
import pytest
import torch

from cadence_tpu.engine.tpu_engine import TPUReplayEngine as JEngine
from cadence_tpu.parallel.mesh import make_mesh
from cadence_tpu_torch.engine.tpu_engine import BulkVerifyResult, TPUReplayEngine, _bucket_events
from cadence_tpu_torch.parallel.mesh import Mesh
from cadence_tpu_torch.utils import metrics as m
from tests.torch_parity import PACKAGES, package, stores_with

SEED = 20260730
SUITES = ("basic", "echo_signal", "timer_retry", "concurrent_child", "ndc")
LISTS = ("divergent", "fallback", "device_errors", "escalated", "resident", "snapshot")


@pytest.fixture(autouse=True)
def _no_resident(monkeypatch):
    monkeypatch.setenv("CADENCE_TPU_RESIDENT", "0")


def corpus(suite, n, seed=SEED, target=40):
    """make_hists(pkg) for one suite of package pkg's generator."""
    return lambda pkg: package(pkg, "gen.corpus").generate_corpus(suite, n, seed=seed,
                                                                  target_events=target)


def engines(pkg, stores, n_dev=1, chunk=8, depth=None):
    if pkg == "cadence_tpu":
        return JEngine(stores, chunk_workflows=chunk, pipeline_depth=depth,
                       mesh=make_mesh(jax.devices()[:n_dev]))
    eng = TPUReplayEngine(stores, chunk_workflows=chunk, pipeline_depth=depth,
                          mesh=Mesh(["cpu"] * n_dev))
    eng.metrics = m.MetricsRegistry()
    return eng


def verify_both(make_hists, tamper=None, **kw):
    """(port result, JAX result, port engine, keys) of verify_all over the
    same histories in each package's stores; tamper(pkg, stores, keys)
    alters them first."""
    out = []
    for pkg in PACKAGES:
        stores, keys = stores_with(make_hists(pkg), pkg)
        if tamper is not None:
            tamper(pkg, stores, keys)
        eng = engines(pkg, stores, **kw)
        out.append((eng.verify_all(), eng, keys))
    (want, _, jkeys), (got, eng, keys) = out
    assert keys == jkeys
    return got, want, eng, keys


def assert_results_equal(got, want):
    assert isinstance(got, BulkVerifyResult)
    assert (got.total, got.verified_on_device) == (want.total, want.verified_on_device)
    for name in LISTS:
        assert list(getattr(got, name)) == list(getattr(want, name)), name


@pytest.mark.parametrize("suite", SUITES)
def test_suite_verifies_as_jax(suite):
    got, want, eng, keys = verify_both(corpus(suite, 12))
    assert_results_equal(got, want)
    assert got.ok and got.verified_on_device == got.total == 12
    # replay_tree_payloads over the same stores: rows, errors, branches
    jstores, jkeys = stores_with(corpus(suite, 12)("cadence_tpu"), "cadence_tpu")
    want_trees = engines("cadence_tpu", jstores).replay_tree_payloads(jkeys)
    for g, w in zip(eng.replay_tree_payloads(keys), want_trees):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_corrupted_live_states_are_divergent():
    picked = (1, 5, 10)

    def tamper(pkg, stores, keys):
        for i in picked:
            stores.execution.get_workflow(*keys[i]).execution_info.signal_count += 1

    got, want, _, keys = verify_both(corpus("echo_signal", 12), tamper)
    assert_results_equal(got, want)
    assert got.divergent == [keys[i] for i in picked]
    assert got.verified_on_device == 12


def test_branch_mismatch_is_divergent():
    """A phantom duplicate branch with the current pointer moved onto it:
    the device arbitrates branch 0, the store claims 1, and the on-device
    branch compare flags it (tests/test_executor.py:310)."""
    def tamper(pkg, stores, keys):
        vhs = stores.execution.get_workflow(*keys[3]).version_histories
        vhs.histories.append(copy.deepcopy(vhs.histories[0]))
        vhs.current_index = 1

    got, want, _, keys = verify_both(corpus("basic", 10), tamper)
    assert_results_equal(got, want)
    assert got.divergent == [keys[3]]


def test_overflow_escalates_on_the_card():
    got, want, _, _ = verify_both(corpus("overflow", 256), chunk=64)
    assert_results_equal(got, want)
    assert got.ok and len(got.escalated) >= 2 and not got.fallback
    assert got.verified_on_device == 256


def _flood(pkg):
    """Four basic histories and one that holds 72 pending activities at
    once, drained before it closes: past the ladder's top rung (4 x 16),
    valid for the oracle."""
    gen = package(pkg, "gen.corpus")
    s = 0
    while random.Random(s).random() >= gen.OVERFLOW_FRACTION:
        s += 1
    w = gen.HistoryWriter(workflow_id="flood", run_id="run-flood")
    gen.gen_overflow(random.Random(s), w, target_events=40, capacity_hint=64)
    return gen.generate_corpus("basic", 4, seed=3, target_events=30) + [w.batches]


def test_ladder_residue_goes_to_the_oracle():
    got, want, _, keys = verify_both(_flood)
    assert_results_equal(got, want)
    assert got.fallback == [keys[4]] and got.device_errors == [(keys[4], 10)]
    assert got.ok and got.verified_on_device == 4 and not got.escalated


def test_corrupt_history_reaches_the_oracle():
    """A history whose last event completes an activity never scheduled:
    the device flags MISSING_ACTIVITY (no capacity clears it), so the
    oracle arbitrates, and the oracle refuses the history in both
    packages with the same error."""
    def tamper(pkg, stores, keys):
        ev = package(pkg, "core.events")
        et = package(pkg, "core.enums").EventType
        last = stores.history.read_events(*keys[1])[-1]
        stores.history.append_batch(*keys[1], [ev.HistoryEvent(
            id=last.id + 1, event_type=et.ActivityTaskCompleted, version=last.version,
            timestamp=last.timestamp + 1, attrs={"scheduled_event_id": 999})])

    errors = []
    for pkg in PACKAGES:
        stores, keys = stores_with(corpus("basic", 3, seed=4, target=30)(pkg), pkg)
        tamper(pkg, stores, keys)
        with pytest.raises(Exception, match="missing activity info") as err:
            engines(pkg, stores).verify_all()
        errors.append((type(err.value).__name__, str(err.value)))
    assert errors[0] == errors[1] and errors[0][0] == "ReplayError"


def _trees(pkg):
    """echo_signal histories forked at their middle batch: branch 1 holds
    two signals at a higher version; even keys switch to it."""
    return package(pkg, "gen.corpus").generate_corpus("echo_signal", 8, seed=6, target_events=30)


def _fork(pkg, stores, keys):
    ev = package(pkg, "core.events")
    et = package(pkg, "core.enums").EventType
    hs = stores.history
    for i, key in enumerate(keys):
        batches = hs.read_batches(*key)
        fork_at = batches[len(batches) // 2][-1]
        b = hs.fork_branch(*key, 0, fork_at.id)
        hs.append_batch(*key, [ev.HistoryEvent(
            id=fork_at.id + k + 1, event_type=et.WorkflowExecutionSignaled,
            version=fork_at.version + 5, timestamp=fork_at.timestamp + k + 1)
            for k in range(2)], branch=b)
        if i % 2 == 0:
            hs.set_current_branch(*key, b)


def test_ndc_trees_equal_jax():
    """Multi-branch trees go through tree_segments (the loser branch
    VH-only): replay_tree_payloads and verify_all equal the JAX
    package's (the live states keep one branch, so each key compares as
    the JAX package compares it)."""
    got, want, eng, keys = verify_both(_trees, _fork)
    assert_results_equal(got, want)
    jstores, jkeys = stores_with(_trees("cadence_tpu"), "cadence_tpu")
    _fork("cadence_tpu", jstores, jkeys)
    jeng = engines("cadence_tpu", jstores)
    seg_shape = [[(len(s[0]), s[1], s[2], s[3]) for s in eng.tree_segments(k)] for k in keys]
    assert seg_shape == [[(len(s[0]), s[1], s[2], s[3]) for s in jeng.tree_segments(k)]
                         for k in jkeys]
    assert all(len(s) == 2 for s in seg_shape)
    rows, errors, branch = eng.replay_tree_payloads(keys)
    for g, w in zip((rows, errors, branch), jeng.replay_tree_payloads(jkeys)):
        assert np.array_equal(g, w)
    # the higher-version fork wins the device's arbitration on every tree
    assert (errors == 0).all() and (branch == 1).all()


def test_long_tail_inflates_only_its_chunk():
    """tests/test_executor.py:199: one long history among short ones sizes
    only its own chunk's event axis."""
    def make(pkg):
        gen = package(pkg, "gen.corpus")
        short = gen.generate_corpus("basic", num_workflows=11, seed=3, target_events=12)
        long_h = gen.generate_corpus("basic", num_workflows=1, seed=9, target_events=160)
        return short[:5] + long_h + short[5:]

    shapes, results = [], []
    for pkg in PACKAGES:
        stores, keys = stores_with(make(pkg), pkg)
        eng = engines(pkg, stores, chunk=4)
        results.append(eng.replay_tree_payloads(keys))
        shapes.append(eng.last_run_chunk_shapes)
    assert shapes[0] == shapes[1] and len(shapes[1]) == 3
    long_e = max(e for _, e in shapes[1])
    assert long_e >= 128 and all(e <= 32 for _, e in shapes[1] if e != long_e)
    for g, w in zip(results[1], results[0]):
        assert np.array_equal(g, w)


def test_mesh_of_2_equals_mesh_of_1_and_jax():
    hists = corpus("overflow", 96, target=60)
    got2, want2, eng, keys = verify_both(hists, n_dev=2, chunk=32, depth=2)
    assert_results_equal(got2, want2)  # JAX's mesh of 2, order included
    got1, _, _, _ = verify_both(hists, n_dev=1, chunk=32, depth=2)
    assert (got1.total, got1.verified_on_device) == (got2.total, got2.verified_on_device)
    for name in LISTS:
        assert sorted(getattr(got1, name)) == sorted(getattr(got2, name)), name
    assert got2.ok and got2.escalated and not got2.fallback
    assert eng.ladder.mesh == Mesh(["cpu", "cpu"])
    for d in range(2):
        assert eng.metrics.counter(m.SCOPE_TPU_EXECUTOR,
                                   m.device_metric(m.M_EXEC_ROWS, d)) >= 1


def test_fresh_default_engine_first_call(monkeypatch):
    """At its default setting (resident tier on) a fresh JAX engine's first
    verify_all over fresh stores serves every key cold: the same result
    as the port's."""
    monkeypatch.delenv("CADENCE_TPU_RESIDENT", raising=False)
    got, want, _, _ = verify_both(corpus("overflow", 64), chunk=16)
    assert_results_equal(got, want)
    assert not want.resident and not want.snapshot


def test_empty_and_default_keys():
    stores, keys = stores_with(corpus("basic", 3)("cadence_tpu_torch"), "cadence_tpu_torch")
    eng = engines("cadence_tpu_torch", stores)
    assert eng.verify_all([]) == BulkVerifyResult(total=0, verified_on_device=0)
    assert eng.verify_all(keys[1:]).total == 2
    assert eng.verify_all().total == 3
    assert set(eng.last_run) == {"expected_rows", "ladder", "arbitrate"}
    rows, errors, branch = eng.replay_tree_payloads([])
    assert rows.shape == (0, eng.layout.width) and errors.shape == branch.shape == (0,)


def test_pack_cache_serves_a_warm_reverify():
    stores, keys = stores_with(corpus("timer_retry", 6)("cadence_tpu_torch"), "cadence_tpu_torch")
    eng = engines("cadence_tpu_torch", stores)
    assert eng.verify_all().ok
    assert eng.metrics.counter(m.SCOPE_PACK_CACHE, m.M_CACHE_MISSES) == 6
    assert eng.verify_all().ok
    assert eng.metrics.counter(m.SCOPE_PACK_CACHE, m.M_CACHE_HITS) == 6


@pytest.mark.parametrize("n,want", [(1, 16), (16, 16), (17, 32), (100, 128)])
def test_bucket_events(n, want):
    from cadence_tpu.engine.tpu_engine import _bucket_events as jb

    assert _bucket_events(n) == jb(n) == want


def test_no_device_named_means_the_card(monkeypatch):
    stores, _ = stores_with(corpus("basic", 2)("cadence_tpu_torch"), "cadence_tpu_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eng = TPUReplayEngine(stores)  # constructing asks for no device
    assert eng.ladder is None
    with pytest.raises(RuntimeError, match="no CUDA"):
        eng.verify_all()
