"""The port's resident state pool (cadence_tpu_torch/engine/resident.py) on
the CPU beside the JAX package's, each cache fed the same histories (each
package generating them with its own gen/corpus.py from the same seed):
every AppendResult and AppendReport field, the keys each cache holds in
LRU order, the counters, and each pinned state (`state_of(entry)` against
JAX's `entry.state`, field by field), exactly. The cases are the
non-Onebox ones of tests/test_resident.py, plus four of the port's own:
a flagged row escalating after a same-call eviction, a batched admit under
a budget smaller than the batch, a mesh of two CPU slices, and an append
the ladder resolves at rung 2 (re-narrowed or not by kernel B's fit)."""
import random

import jax
import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import DEFAULT_LAYOUT, STICKY_ROW_INDEX
from cadence_tpu.engine.ladder import EscalationLadder as JLadder
from cadence_tpu.engine.resident import ResidentStateCache as JCache
from cadence_tpu.parallel.mesh import make_mesh
from cadence_tpu.utils import metrics as jm
from cadence_tpu_torch.engine import resident as tres
from cadence_tpu_torch.engine.ladder import EscalationLadder
from cadence_tpu_torch.engine.resident import ResidentStateCache
from cadence_tpu_torch.parallel.mesh import Mesh
from cadence_tpu_torch.utils import metrics as m
from tests.torch_parity import (PACKAGES, assert_states_equal, overflow_chain, package,
                                reset_port_tiers)

SUITES = ("basic", "echo_signal", "timer_retry", "concurrent_child", "ndc")
COUNTERS = (m.M_CACHE_HITS, m.M_RESIDENT_SUFFIX_HITS, m.M_CACHE_MISSES, m.M_CACHE_INVALIDATIONS,
            m.M_CACHE_EVICTIONS, m.M_RESIDENT_EVENTS_APPENDED, m.M_RESIDENT_WIDENED,
            m.M_RESIDENT_NARROWED)


@pytest.fixture(autouse=True)
def _isolated():
    yield
    reset_port_tiers()


def caches(**kw):
    """(JAX cache, port cache) with their own registries and ladders."""
    ladder = kw.pop("ladder", True)
    n_dev = kw.pop("n_dev", 0)
    device = kw.pop("device", "cpu")
    jreg, treg = jm.MetricsRegistry(), m.MetricsRegistry()
    jc = JCache(DEFAULT_LAYOUT, registry=jreg,
                ladder=JLadder(DEFAULT_LAYOUT, registry=jreg) if ladder else None,
                mesh=make_mesh(jax.devices()[:n_dev]) if n_dev else None, **kw)
    tc = ResidentStateCache(DEFAULT_LAYOUT, registry=treg, device=device,
                            ladder=(EscalationLadder(DEFAULT_LAYOUT, registry=treg, device="cpu")
                                    if ladder else None),
                            mesh=Mesh(["cpu"] * n_dev) if n_dev else None, **kw)
    return jc, tc


def hists(pkg, suite, n, seed, target):
    return package(pkg, "gen.corpus").generate_corpus(suite, num_workflows=n, seed=seed,
                                                      target_events=target)


def replay_full(pkg, batches_list):
    """(state, payload rows, branch) of a full replay in package pkg."""
    enc = package(pkg, "ops.encode")
    rows_list = [enc.encode_batches_resumable(h)[0] for h in batches_list]
    corpus = enc.assemble_corpus(rows_list, max(r.shape[0] for r in rows_list))
    payload = package(pkg, "ops.payload")
    if pkg == "cadence_tpu":
        s = package(pkg, "ops.replay").replay_events(corpus)
    else:
        s = package(pkg, "ops.replay").replay_events(corpus, device="cpu")
    rows = payload.payload_rows(s)
    return s, np.asarray(rows), np.asarray(s.current_branch)


def seed(pkg, cache, keys, prefixes):
    """Pin each workflow's prefix state, one admit after another."""
    s, rows, branch = replay_full(pkg, prefixes)
    address = package(pkg, "engine.cache").content_address
    return [cache.admit(k, address(p), cache.extract_row(s, i), rows[i], int(branch[i]))
            for i, (k, p) in enumerate(zip(keys, prefixes))]


def oracle_row(pkg, batches):
    ms = package(pkg, "oracle.state_builder").StateBuilder().replay_history(batches)
    row = package(pkg, "core.checksum").payload_row(ms, DEFAULT_LAYOUT)
    row[STICKY_ROW_INDEX] = 0
    return row


def assert_same(jc, tc):
    """Same keys in LRU order per slice, same bytes, counters, and each
    entry's payload, branch, address, rung and state."""
    assert tc.keys() == jc.keys()
    assert [list(s.keys()) for s in tc._slices] == [list(s.keys()) for s in jc._slices]
    assert tc.resident_bytes == jc.resident_bytes
    for name in COUNTERS:
        assert (tc.metrics.counter(m.SCOPE_TPU_RESIDENT, name)
                == jc.metrics.counter(jm.SCOPE_TPU_RESIDENT, name)), name
    for key in jc.keys():
        je, te = jc.entry_for(key), tc.entry_for(key)
        assert np.array_equal(te.payload, je.payload)
        assert (te.branch, tuple(te.address), te.rung, te.nbytes) == \
            (je.branch, tuple(je.address), je.rung, je.nbytes)
        assert_states_equal(tc.state_of(te), je.state)


def assert_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.ok, g.branch, g.error, g.rung, g.escalated) == \
            (w.ok, w.branch, w.error, w.rung, w.escalated)
        assert (g.payload is None) == (w.payload is None)
        if w.payload is not None:
            assert np.array_equal(np.asarray(g.payload), np.asarray(w.payload))


def assert_reports(tc, jc):
    g, w = tc.last_append, jc.last_append
    assert (g.transactions, g.events_appended, g.escalated_rows, g.chunk_shapes) == \
        (w.transactions, w.events_appended, w.escalated_rows, w.chunk_shapes)


def append_both(jc, tc, keys, full):
    """replay_append of every key's full history on both caches (each
    looking its entries up first); returns the port's results."""
    out = []
    for pkg, cache in (("cadence_tpu", jc), ("cadence_tpu_torch", tc)):
        items = [(k, cache.lookup(k, h)[1], h) for k, h in zip(keys, full[pkg])]
        out.append(cache.replay_append(items))
    assert_results(out[1], out[0])
    assert_reports(tc, jc)
    assert_same(jc, tc)
    return out[1]


def prefixed(suite, n, seed_, target, cut=-1):
    """{pkg: histories}, {pkg: prefixes}, keys."""
    full = {pkg: hists(pkg, suite, n, seed_, target) for pkg in PACKAGES}
    pre = {pkg: [h[:cut] for h in full[pkg]] for pkg in PACKAGES}
    return full, pre, [("d", f"w{i}", "r") for i in range(n)]


def seed_both(jc, tc, keys, pre):
    assert seed("cadence_tpu", jc, keys, pre["cadence_tpu"]) == \
        seed("cadence_tpu_torch", tc, keys, pre["cadence_tpu_torch"])
    assert_same(jc, tc)


@pytest.mark.parametrize("suite", SUITES)
def test_suffix_parity_every_suite(suite):
    jc, tc = caches()
    full, pre, keys = prefixed(suite, 8, 11, 40)
    seed_both(jc, tc, keys, pre)
    results = append_both(jc, tc, keys, full)
    for h, res in zip(full["cadence_tpu_torch"], results):
        assert res.ok and np.array_equal(res.payload, oracle_row("cadence_tpu_torch", h))
    for k, h in zip(keys, full["cadence_tpu_torch"]):
        assert tc.lookup(k, h)[0] == "exact"


def test_widen_then_suffix_replay_then_narrow():
    """A base state widened to 2K replays the suffix to the same base-width
    payload, and narrows back: the ops the resident ladder runs."""
    from cadence_tpu.ops import replay as jr
    from cadence_tpu.ops import state as js
    from cadence_tpu_torch.ops import replay as tr
    from cadence_tpu_torch.ops import state as ts

    wide = js.widen_layout(DEFAULT_LAYOUT, 2)
    got = {}
    for pkg in PACKAGES:
        enc = package(pkg, "ops.encode")
        hs = hists(pkg, "timer_retry", 5, 7, 36)
        prefixes = [enc.encode_batches_resumable(h[:-1]) for h in hs]
        pref = enc.assemble_corpus([r for r, _ in prefixes], max(r.shape[0] for r, _ in prefixes))
        suf_rows = [enc.encode_batches_resumable(h[-1:], mp)[0] for h, (_, mp) in zip(hs, prefixes)]
        suf = enc.assemble_corpus(suf_rows, max(r.shape[0] for r in suf_rows))
        if pkg == "cadence_tpu":
            s_wide = js.widen_state(jr.replay_events(pref), wide)
            s_fin, rows, err, ovf = jr.replay_from_state_to_payload(suf, s_wide, DEFAULT_LAYOUT)
            got[pkg] = (s_fin, js.narrow_ok(s_fin, DEFAULT_LAYOUT),
                        js.narrow_state(s_fin, DEFAULT_LAYOUT), rows, err)
        else:
            s_wide = ts.widen_state(tr.replay_events(pref, device="cpu"), wide)
            s_fin, rows, err, ovf = tr.replay_from_state_to_payload(suf, s_wide, DEFAULT_LAYOUT,
                                                                    device="cpu")
            got[pkg] = (s_fin, ts.narrow_ok(s_fin, DEFAULT_LAYOUT),
                        ts.narrow_state(s_fin, DEFAULT_LAYOUT), rows, err)
    (js_fin, jok, jnar, jrows, jerr), (ts_fin, tok, tnar, trows, terr) = \
        got["cadence_tpu"], got["cadence_tpu_torch"]
    assert_states_equal(ts_fin, js_fin)
    assert_states_equal(tnar, jnar)
    assert np.array_equal(tok.numpy(), np.asarray(jok)) and tok.all()
    assert np.array_equal(trows.numpy(), np.asarray(jrows)) and not terr.any()


def test_lookup_exact_suffix_stale():
    jc, tc = caches()
    full, pre, keys = prefixed("basic", 2, 13, 24)
    seed_both(jc, tc, keys, pre)
    out = []
    for pkg, cache in (("cadence_tpu", jc), ("cadence_tpu_torch", tc)):
        h = full[pkg]
        seen = [cache.lookup(keys[0], h[0][:-1])[0], cache.lookup(keys[0], h[0])[0]]
        mutated = list(h[1][:-2]) + [h[1][-1]]
        seen.append(cache.lookup(keys[1], mutated))
        seen.append(cache.lookup(keys[1], h[1][:-1]))
        seen.append(cache.lookup(keys[0], h[0][:1], authoritative=False))
        seen.append(cache.lookup(keys[0], h[0][:-1])[0])
        out.append(seen)
    assert out[1] == out[0] == ["exact", "suffix", None, None, None, "exact"]
    assert_same(jc, tc)
    assert tc.metrics.counter(m.SCOPE_TPU_RESIDENT, m.M_CACHE_INVALIDATIONS) == 1


def test_lru_eviction_at_budget():
    row = tres.ResidentStateCache(DEFAULT_LAYOUT, device="cpu")._row_nbytes(DEFAULT_LAYOUT)
    assert row == JCache(DEFAULT_LAYOUT)._row_nbytes(DEFAULT_LAYOUT) == 3602 + 89 * 8
    jc, tc = caches(budget_bytes=3 * row + 1)
    full, pre, keys = prefixed("basic", 5, 17, 20)
    seed_both(jc, tc, keys, pre)
    assert tc.keys() == keys[2:]
    assert tc.metrics.counter(m.SCOPE_TPU_RESIDENT, m.M_CACHE_EVICTIONS) == 2
    assert tc.metrics.gauge_value(m.SCOPE_TPU_RESIDENT, m.M_RESIDENT_BYTES) == tc.resident_bytes
    assert tc.metrics.gauge_value(m.SCOPE_TPU_RESIDENT, m.M_RESIDENT_ENTRIES) == 3
    # the slabs hold every slot they were given: a 64-row slab
    assert tc.slab_bytes == 64 * 3602


def test_oversized_budget_rejects_admission():
    jc, tc = caches(budget_bytes=16)
    full, pre, keys = prefixed("basic", 1, 19, 20)
    assert seed("cadence_tpu", jc, keys, pre["cadence_tpu"]) == [False]
    assert seed("cadence_tpu_torch", tc, keys, pre["cadence_tpu_torch"]) == [False]
    assert len(tc) == len(jc) == 0 and tc.slab_bytes == 0


def test_replay_append_parity_and_readdress():
    jc, tc = caches()
    full, pre, keys = prefixed("concurrent_child", 4, 23, 40)
    seed_both(jc, tc, keys, pre)
    append_both(jc, tc, keys, full)
    for k, h in zip(keys, full["cadence_tpu_torch"]):
        assert tc.lookup(k, h)[0] == "exact"
    assert tc.last_append.events_appended == sum(len(h[-1].events)
                                                 for h in full["cadence_tpu_torch"])


def test_overflowing_append_widens_and_renarrows():
    """The rung-1 append re-narrows exactly the row the JAX pool does: the
    fit flag comes from kernel B's fit epilogue on the appended state."""
    jc, tc = caches()
    chain = {pkg: overflow_chain(pkg) for pkg in PACKAGES}
    key = ("d", "ovf", "r")
    seed_both(jc, tc, [key], {pkg: [c[0]] for pkg, c in chain.items()})
    res = append_both(jc, tc, [key], {pkg: [c[1]] for pkg, c in chain.items()})[0]
    assert res.ok and res.escalated and res.rung == 1
    assert tc.entry_for(key).rung == 1 and tc.stats()["widened_entries"] == 1
    assert_same(jc, tc)
    res = append_both(jc, tc, [key], {pkg: [c[2]] for pkg, c in chain.items()})[0]
    assert res.ok and res.rung == 0 and tc.entry_for(key).rung == 0
    assert tc.metrics.counter(m.SCOPE_TPU_RESIDENT, m.M_RESIDENT_NARROWED) == 1
    assert np.array_equal(res.payload, oracle_row("cadence_tpu_torch", chain["cadence_tpu_torch"][2]))
    assert_same(jc, tc)


def flood_chain(pkg, flood: int, keep: int):
    """(prefix, full history) in package pkg: the prefix pins 2
    activities; the append schedules `flood` more (slots 2 on) and
    completes all of them but the last `keep`, so its replay needs the
    ladder's rung 2 (64 slots) while its final state holds 2 + keep."""
    gen = package(pkg, "gen.corpus")
    ET = package(pkg, "core.enums").EventType
    w = gen.HistoryWriter(workflow_id="flood")
    gen._start(w, random.Random(0))
    cyc = gen._run_decision(w, 2)
    gen._begin_decision_completed_batch(w, cyc)

    def schedule(prefix, n):
        return [w.add(ET.ActivityTaskScheduled, activity_id=f"{prefix}{i}", task_list="res-tl",
                      schedule_to_start_timeout_seconds=60,
                      schedule_to_close_timeout_seconds=120,
                      start_to_close_timeout_seconds=60, heartbeat_timeout_seconds=0)
                for i in range(n)]

    schedule("p", 2)
    sched = gen._schedule_decision(w, in_batch=True)
    w.end_batch()
    prefix = list(w.batches)
    cyc = gen._run_decision(w, sched)
    gen._begin_decision_completed_batch(w, cyc)
    acts = schedule("f", flood)
    gen._schedule_decision(w, in_batch=True)
    w.end_batch()
    for ev in acts[:flood - keep]:
        started = w.single(ET.ActivityTaskStarted, scheduled_event_id=ev.id,
                           request_id=f"poll-{ev.id}")
        w.begin_batch()
        w.add(ET.ActivityTaskCompleted, scheduled_event_id=ev.id, started_event_id=started.id)
        w.end_batch()
    return prefix, list(w.batches)


@pytest.mark.parametrize("keep,rung", [(0, 0), (3, 2)])
def test_escalate_resident_rung2_fit_equals_jax(keep, rung):
    """An append that overflows rungs 0 and 1 and resolves at rung 2: with
    every flooded activity completed its final state fits the base layout
    and is re-admitted narrowed; with the last 3 left open (5 entries, 3 in
    slots past 16) it overflows nothing and does not fit, and stays at rung
    2. The fit comes from kernel B's fit epilogue in escalate_resident;
    results, entries and counters equal the JAX pool's."""
    jc, tc = caches()
    chain = {pkg: flood_chain(pkg, 40, keep) for pkg in PACKAGES}
    key = ("d", "flood", "r")
    seed_both(jc, tc, [key], {pkg: [c[0]] for pkg, c in chain.items()})
    res = append_both(jc, tc, [key], {pkg: [c[1]] for pkg, c in chain.items()})[0]
    assert res.ok and res.escalated and res.rung == rung
    assert [r["rung"] for r in tc.ladder.last_run] == [1, 2]
    assert tc.entry_for(key).rung == rung
    assert (tc.metrics.counter(m.SCOPE_TPU_RESIDENT, m.M_RESIDENT_NARROWED)
            == (1 if rung == 0 else 0))
    assert np.array_equal(res.payload,
                          oracle_row("cadence_tpu_torch", chain["cadence_tpu_torch"][1]))
    assert_same(jc, tc)


def test_no_ladder_falls_back_cleanly():
    jc, tc = caches(ladder=False)
    chain = {pkg: overflow_chain(pkg) for pkg in PACKAGES}
    key = ("d", "ovf", "r")
    seed_both(jc, tc, [key], {pkg: [c[0]] for pkg, c in chain.items()})
    res = append_both(jc, tc, [key], {pkg: [c[1]] for pkg, c in chain.items()})[0]
    assert not res.ok and res.error == -1 and len(tc) == 0


def test_suffix_chunks_through_pipeline_depth3():
    jc, tc = caches(chunk_workflows=4, pipeline_depth=3)
    full, pre, keys = prefixed("basic", 12, 29, 48)
    seed_both(jc, tc, keys, pre)
    append_both(jc, tc, keys, full)
    shapes = tc.last_append.chunk_shapes
    assert len(shapes) == 3 and all(e <= 16 for _, e in shapes)


def test_append_shapes_independent_of_history_length():
    shapes = {}
    for label, target in (("short", 24), ("long", 160)):
        jc, tc = caches()
        full, pre, _ = prefixed("basic", 6, 31, target)
        keys = [("d", f"w{i}-{label}", "r") for i in range(6)]
        seed_both(jc, tc, keys, pre)
        append_both(jc, tc, keys, full)
        shapes[label] = tc.last_append.chunk_shapes
    assert shapes["short"] == shapes["long"]


def test_flagged_row_escalates_after_same_call_eviction():
    """Two chunks of three. Chunk 0's two overflow rows re-admit widened
    (more bytes) and evict C1 and then F1, chunk 1's clean and flagged
    rows; chunk 1's re-admit of C1 then takes a new slot before the ladder
    reads F1's pre-append state from F1's freed slot. A slot freed inside
    the call must not be reused there: results, evictions and states equal
    JAX's, and F1 resolves on the ladder."""
    row = JCache(DEFAULT_LAYOUT)._row_nbytes(DEFAULT_LAYOUT)
    names = ["F0a", "F0b", "X", "C1", "F1", "Y"]
    keys = {n: ("d", n, "r") for n in names}
    jc, tc = caches(budget_bytes=6 * row + 1, chunk_workflows=3)
    out = []
    for pkg, cache in zip(PACKAGES, (jc, tc)):
        basic = hists(pkg, "basic", 3, 53, 30)
        prefix, append1, _ = overflow_chain(pkg)
        full = dict(zip(["X", "C1", "Y"], basic), F0a=append1, F0b=append1, F1=append1)
        pre = dict(zip(["X", "C1", "Y"], [h[:-1] for h in basic]),
                   F0a=prefix, F0b=prefix, F1=prefix)
        seed(pkg, cache, [keys[n] for n in names], [pre[n] for n in names])
        found = {n: cache.lookup(keys[n], full[n])  # this lookup order is the LRU order
                 for n in ["C1", "F1", "F0a", "F0b", "X", "Y"]}
        out.append(cache.replay_append([(keys[n], found[n][1], full[n]) for n in names]))
    assert_results(out[1], out[0])
    assert_reports(tc, jc)
    assert_same(jc, tc)
    assert [(r.ok, r.escalated, r.rung) for r in out[1]] == \
        [(True, True, 1), (True, True, 1), (True, False, 0), (True, False, 0),
         (True, True, 1), (True, False, 0)]
    assert tc.metrics.counter(m.SCOPE_TPU_RESIDENT, m.M_CACHE_EVICTIONS) >= 2


def test_batched_admit_under_a_small_budget_is_sequential():
    """Six admit_row calls in one batch() into a budget of four give JAX's
    one-by-one admits: the same keys kept, in the same order, with their
    states; the two rows evicted inside the batch are never written."""
    row = JCache(DEFAULT_LAYOUT)._row_nbytes(DEFAULT_LAYOUT)
    jc, tc = caches(budget_bytes=4 * row)
    full, pre, keys = prefixed("echo_signal", 6, 41, 30)
    seed("cadence_tpu", jc, keys, pre["cadence_tpu"])
    s, rows, branch = replay_full("cadence_tpu_torch", pre["cadence_tpu_torch"])
    address = package("cadence_tpu_torch", "engine.cache").content_address
    with tc.batch():
        ok = [tc.admit_row(k, address(p), s, i, rows[i], int(branch[i]))
              for i, (k, p) in enumerate(zip(keys, pre["cadence_tpu_torch"]))]
        assert len(tc._writes) == 4  # the evicted rows' writes are dropped
    assert ok == [True] * 6 and not tc._writes
    assert tc.keys() == keys[2:]
    assert_same(jc, tc)
    # slots: the four kept rows hold distinct slots of one 64-row slab
    slots = [tc.entry_for(k).slot.index for k in keys[2:]]
    assert len(set(slots)) == 4


def test_mesh_of_two_cpu_slices_keeps_jax_per_shard_lru():
    row = JCache(DEFAULT_LAYOUT)._row_nbytes(DEFAULT_LAYOUT)
    jc, tc = caches(budget_bytes=6 * row, n_dev=2)
    full, pre, keys = prefixed("timer_retry", 10, 43, 30)
    seed_both(jc, tc, keys, pre)
    assert tc.n_shards == 2 and [len(s) for s in tc._slices] == [len(s) for s in jc._slices]
    assert tc.device_of(keys[0]) is not None
    kept = [i for i, k in enumerate(keys) if k in jc.keys()]
    assert 0 < len(kept) < len(keys)  # each slice evicted on its own
    append_both(jc, tc, [keys[i] for i in kept],
                {pkg: [full[pkg][i] for i in kept] for pkg in PACKAGES})
    assert {k: tc.shard_of(k) for k in keys} == {k: jc.shard_of(k) for k in keys}
    assert len(tc._slabs) == 2


def test_set_mesh_rebinds_and_clear_frees_the_slabs():
    jc, tc = caches()
    full, pre, keys = prefixed("basic", 3, 47, 20)
    seed_both(jc, tc, keys, pre)
    for cache, mesh in ((jc, make_mesh(jax.devices()[:2])), (tc, Mesh(["cpu", "cpu"]))):
        cache.set_mesh(mesh)
    assert len(tc) == len(jc) == 0 and tc.slab_bytes == 0
    seed_both(jc, tc, keys, pre)
    tres.reset_all()
    assert len(tc) == 0 and tc.slab_bytes == 0


def _seed_and_append_through(jc, tc):
    """Seed a batch of rows inside one pool call, then append to them
    (one overflowing), on both caches; the port's state must equal JAX's
    at each step."""
    chain = {pkg: overflow_chain(pkg) for pkg in PACKAGES}
    full, pre, keys = prefixed("echo_signal", 6, 59, 30)
    for pkg in PACKAGES:
        full[pkg].append(chain[pkg][1])
        pre[pkg].append(chain[pkg][0])
    keys.append(("d", "ovf", "r"))
    seed("cadence_tpu", jc, keys, pre["cadence_tpu"])
    with tc.batch():
        seed("cadence_tpu_torch", tc, keys, pre["cadence_tpu_torch"])
        assert len(tc._writes) == len(keys)  # recorded, launched at the end
    assert not tc._writes
    assert_same(jc, tc)
    results = append_both(jc, tc, keys, full)
    assert results[-1].escalated and results[-1].rung == 1
    return keys


def test_rows_from_another_device_stack_on_the_host(monkeypatch):
    """Rows from the CPU into a slab on a card (snapshot hydration) are
    stacked on the host and copied once per state tensor: admits, appends
    and escalations still equal JAX's. The route is forced here, as the
    CPU has no second device."""
    monkeypatch.setattr(tres, "_write_route", lambda src, slab: "host")
    jc, tc = caches()
    keys = _seed_and_append_through(jc, tc)
    assert tc.host_rows >= len(keys)


def test_rows_from_another_card_are_gathered_there(monkeypatch):
    """Rows from another card are gathered by kernel G on their own device
    and copied once per state tensor, never through the host (the route
    forced on the CPU)."""
    routes = []

    def device_route(src, slab):
        routes.append((src, slab))
        return "device"

    monkeypatch.setattr(tres, "_write_route", device_route)
    jc, tc = caches()
    _seed_and_append_through(jc, tc)
    assert routes and tc.host_rows == 0


@pytest.mark.parametrize("name", ["cpu:0", "cpu"])
def test_a_device_named_without_its_tensors_index_writes_in_place(monkeypatch, name):
    """A pool on a device named otherwise than its tensors name it ("cpu:0"
    for the CPU, as "cuda" for cuda:0) keeps its slabs on the tensors'
    device, so its rows from that device take the local route: no host
    stacking, no copy."""
    seen = []
    route = tres._write_route
    monkeypatch.setattr(tres, "_write_route",
                        lambda src, slab: seen.append(route(src, slab)) or seen[-1])
    jc, tc = caches(device=name)
    _seed_and_append_through(jc, tc)
    assert {slab.device for slab in tc._slabs.values()} == {torch.device("cpu")}
    assert seen and set(seen) == {"local"} and tc.host_rows == 0
    assert Mesh([name, "cpu"]).devices == (torch.device("cpu"),) * 2
