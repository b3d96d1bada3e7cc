"""The port's mesh across real CUDA cards, beside the same work on one card.

These tests need the card (marker `cuda`): each decides inside itself
whether there are enough CUDA devices and skips otherwise, so on a box
without a card they all skip. They import nothing of JAX or of the JAX
package; run them on a machine with cards without the conftest, which
imports JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cards.py -q

With several cards every shard's launches run on its own card (the
kernels go through one ctypes library, which launches on the current
device); the results must equal a mesh of one card, row for row.
"""
import time

import numpy as np
import pytest
import torch

from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT
from cadence_tpu_torch.gen.corpus import generate_corpus
from cadence_tpu_torch.ops.encode import encode_corpus, gather_subcorpus, to_wire32
from cadence_tpu_torch.ops.state import widen_layout
from cadence_tpu_torch.ops.wirec import pack_wirec
from cadence_tpu_torch.parallel import mesh as pm

pytestmark = pytest.mark.cuda
SEED = 20260730


def _cards(at_least: int) -> pm.Mesh:
    """A mesh over every CUDA card, or a skip when there are fewer than
    `at_least`."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < at_least:
        pytest.skip(f"needs {at_least} CUDA card(s), found {n}")
    return pm.make_mesh()


def _stores(hists):
    from cadence_tpu_torch.engine.persistence import Stores
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    stores = Stores()
    for h in hists:
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        for b in h:
            stores.history.append_batch(*key, list(b.events))
        stores.execution.upsert_workflow(StateBuilder().replay_history(h))
    return stores


@pytest.fixture(scope="module")
def lanes():
    hists = [h for s in ("basic", "timer_retry", "concurrent_child", "ndc")
             for h in generate_corpus(s, 64, seed=SEED, target_events=60)]
    return encode_corpus(hists)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.device == w.device and torch.equal(g, w)


def test_sharded_replays_across_cards(lanes):
    cards = _cards(2)
    one = pm.Mesh([cards.devices[0]])
    _equal(pm.replay_sharded(lanes, cards), pm.replay_sharded(lanes, one))
    ev32 = to_wire32(lanes)
    _equal(pm.replay_sharded_crc(ev32, cards), pm.replay_sharded_crc(ev32, one))
    corpus = pack_wirec(lanes)
    _equal(pm.replay_wirec_sharded_crc(corpus, cards), pm.replay_wirec_sharded_crc(corpus, one))
    wide = widen_layout(DEFAULT_LAYOUT, 2)
    sub = gather_subcorpus(lanes, np.arange(cards.size * 8), cards.size * 8)
    _equal(pm.replay_sharded_escalated(sub, cards, wide),
           pm.replay_sharded_escalated(sub, one, wide))
    subw = pack_wirec(sub)
    _equal(pm.replay_wirec_sharded_escalated_crc(subw, cards, wide),
           pm.replay_wirec_sharded_escalated_crc(subw, one, wide))


def test_serving_paths_across_cards(lanes):
    from cadence_tpu_torch.engine.executor import replay_corpus_mesh, stream_wirec_mesh
    from cadence_tpu_torch.utils.metrics import MetricsRegistry

    cards = _cards(2)
    one = pm.Mesh([cards.devices[0]])
    got = replay_corpus_mesh(lanes, cards, chunk_workflows=64, registry=MetricsRegistry())
    want = replay_corpus_mesh(lanes, one, chunk_workflows=64, registry=MetricsRegistry())
    assert got[3].chunks == want[3].chunks == 4
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    corpus = pack_wirec(lanes)
    got = stream_wirec_mesh(corpus, cards, n_chunks=2, registry=MetricsRegistry())
    want = stream_wirec_mesh(corpus, one, n_chunks=2, registry=MetricsRegistry())
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_verify_all_across_cards():
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine

    cards = _cards(2)
    hists = generate_corpus("overflow", 512, seed=SEED, target_events=60)
    stores = _stores(hists)
    keys = stores.execution.list_executions()
    stores.execution.get_workflow(*keys[7]).execution_info.signal_count += 1
    got = TPUReplayEngine(stores, chunk_workflows=128, mesh=cards).verify_all()
    want = TPUReplayEngine(stores, chunk_workflows=128,
                           mesh=pm.Mesh([cards.devices[0]])).verify_all()
    assert (got.total, got.verified_on_device) == (want.total, want.verified_on_device)
    for name in ("divergent", "fallback", "device_errors", "escalated"):
        assert sorted(getattr(got, name)) == sorted(getattr(want, name)), name
    assert got.divergent == [keys[7]] and got.escalated


def test_rebuild_across_cards():
    from cadence_tpu_torch.core.checksum import payload_row
    from cadence_tpu_torch.engine.rebuild import DeviceRebuilder

    cards = _cards(2)
    jobs = [(h, None) for h in generate_corpus("overflow", 300, seed=SEED, target_events=60)]
    got_rb = DeviceRebuilder(chunk_jobs=101, mesh=cards)
    want_rb = DeviceRebuilder(chunk_jobs=101, mesh=pm.Mesh([cards.devices[0]]))
    got, want = got_rb.rebuild(jobs), want_rb.rebuild(jobs)
    for g, w in zip(got, want):
        assert np.array_equal(payload_row(g), payload_row(w))
    assert (got_rb.stats.device, got_rb.stats.ladder) == (want_rb.stats.device,
                                                          want_rb.stats.ladder)


def test_streaming_on_one_card(lanes):
    from cadence_tpu_torch.ops.streaming import replay_streamed

    _cards(1)
    rows, errors = replay_streamed(lanes, 16, device="cuda")
    want_rows, want_errors = replay_streamed(lanes, 16, device="cpu")
    assert np.array_equal(rows, want_rows) and np.array_equal(errors, want_errors)


def test_sharded_generator_across_cards():
    """The north star's code path on every card: the fused generator,
    replay, payload and CRC, each shard on its own card, equal to one card
    and to the unsharded call; and the feeder over the cards."""
    from cadence_tpu_torch.native.feeder import feed_corpus
    from cadence_tpu_torch.ops.genkernel import (generate_and_replay_crc,
                                                 generate_and_replay_sharded,
                                                 generate_and_replay_sharded_crc)

    cards = _cards(4)
    one = pm.Mesh([cards.devices[0]])
    W = 1024 * cards.size
    _equal(generate_and_replay_sharded_crc(SEED, 0, W, 200, cards),
           generate_and_replay_sharded_crc(SEED, 0, W, 200, one))
    _equal(generate_and_replay_sharded(SEED, 4096, W, 200, cards),
           generate_and_replay_sharded(SEED, 4096, W, 200, one))
    _equal(generate_and_replay_sharded_crc(SEED, 0, W, 200, one),
           generate_and_replay_crc(SEED, 0, W, 200, device=cards.devices[0]))
    hists = generate_corpus("timer_retry", 256, seed=SEED, target_events=60)
    got = feed_corpus(hists, chunk_workflows=64, mesh=cards)
    want = feed_corpus(hists, chunk_workflows=64, mesh=one)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_graft_entry_dryrun_across_cards():
    """graft_entry.dryrun_multichip over every card: each payload row equal
    to the oracle's, the one-shot sharded replay's rows and stats, the
    wirec stream's CRCs, then the same rows from the cards reversed and,
    with four or more, from half of them."""
    from cadence_tpu_torch.graft_entry import dryrun_multichip

    mesh = _cards(2)
    line = dryrun_multichip(mesh.size)
    assert line["devices"] == mesh.size and line["workflows"] >= 4096


# -- the resident pool, the serving scheduler, migration and the standby
# apply over a pool sharded across the cards: each run on a mesh of every
# card and on a mesh of the first card alone (as many slices, so the same
# budget split and LRU order, or one slice), row for row

def _timed(test: str, run, mesh, *args):
    """run(mesh, *args), its wall printed beside the mesh's cards and
    slices (printed, not gated: `pytest -s` shows it)."""
    t0 = time.perf_counter()
    out = run(mesh, *args)
    cards = len({torch.device(d) for d in mesh.devices})
    print(f"\n{test}: {cards} card(s), {mesh.size} slice(s): {time.perf_counter() - t0:.3f} s")
    return out


def _keys(hists):
    return [(h[0].domain_id, h[0].workflow_id, h[0].run_id) for h in hists]


def _fresh_registry():
    """The pool, the ladder and the serving and replication counters land
    in the default registry: each run starts it empty and the runs are
    made one after another."""
    from cadence_tpu_torch.engine import resident, serving
    from cadence_tpu_torch.utils.metrics import DEFAULT_REGISTRY

    serving.reset_all()
    resident.reset_all()
    DEFAULT_REGISTRY.reset()
    return DEFAULT_REGISTRY


def _pool_rows(pool, keys):
    """key -> (payload, branch, address, rung, the row's 66 state tensors
    on the host), None where the key is not resident."""
    from cadence_tpu_torch.ops.state import leaves

    out = {}
    for k in keys:
        e = pool.entry_for(k)
        out[k] = None if e is None else (
            np.asarray(e.payload).tolist(), int(e.branch), tuple(e.address), e.rung,
            [(n, t.cpu()) for n, t in leaves(pool.state_of(e))])
    return out


def _rows_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k] is None or got[k] is None:
            assert got[k] is None and want[k] is None, k
            continue
        assert got[k][:4] == want[k][:4], k
        for (n, g), (_, w) in zip(got[k][4], want[k][4]):
            assert torch.equal(g, w), (k, n)


def _slabs_on_their_cards(pool, mesh):
    from cadence_tpu_torch.device import canonical_device
    from cadence_tpu_torch.ops.state import leaves

    assert pool._slabs
    for (shard, _layout), slab in pool._slabs.items():
        assert slab.device == canonical_device(mesh.devices[shard])
        assert all(t.device == slab.device for _, t in leaves(slab.state))


def test_resident_pool_across_cards():
    """set_mesh over every card: a slice on each card with its share of the
    budget and its own LRU order, every row admitted from the first card
    and appended to on its own card. The kept keys, their LRU order and
    their rows equal a pool of as many slices on the first card; each row
    equals a one-slice pool's with room for all; rows that come from
    another card never stack on the host (host_rows stays 0)."""
    from cadence_tpu_torch.engine.cache import content_address
    from cadence_tpu_torch.engine.persistence import Stores
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine
    from cadence_tpu_torch.ops.payload import payload_rows
    from cadence_tpu_torch.ops.replay import replay_events
    from cadence_tpu_torch.ops.encode import assemble_corpus, encode_batches_resumable

    cards = _cards(2)
    first = cards.devices[0]
    hists = [h for s in ("timer_retry", "concurrent_child") for h in
             generate_corpus(s, 48, seed=SEED, target_events=40)]
    keys, prefixes = _keys(hists), [h[:-2] for h in hists]
    rows_list = [encode_batches_resumable(p)[0] for p in prefixes]
    corpus = assemble_corpus(rows_list, max(r.shape[0] for r in rows_list))

    def run(mesh, budget_rows):
        _fresh_registry()
        tpu = TPUReplayEngine(Stores(), mesh=mesh)
        pool = tpu.resident
        pool.budget_bytes = budget_rows * pool._row_nbytes(DEFAULT_LAYOUT)
        s = replay_events(corpus, device=first)  # the prefixes, on the first card
        payload = payload_rows(s).cpu().numpy()
        branch = s.current_branch.cpu().numpy()
        with pool.batch():
            for i, (k, p) in enumerate(zip(keys, prefixes)):
                pool.admit_row(k, content_address(p), s, i, payload[i], int(branch[i]))
        hits = [(k, hit[1], h) for k, h in zip(keys, hists) if (hit := pool.lookup(k, h))]
        results = pool.replay_append(hits)
        torch.cuda.synchronize()
        return pool, {k: (r.ok, r.error, r.rung, r.escalated)
                      for (k, _, _), r in zip(hits, results)}, _pool_rows(pool, keys)

    budget = 8 * cards.size  # each slice keeps 8 of its keys
    pool, results, rows = _timed("resident_pool", run, cards, budget)
    assert pool.n_shards == cards.size and pool.slice_budget == pool.budget_bytes // cards.size
    _slabs_on_their_cards(pool, cards)
    assert pool.host_rows == 0
    assert 0 < len(pool) < len(keys) and all(
        sum(e.nbytes for e in sl.values()) <= pool.slice_budget for sl in pool._slices)
    slices = [list(sl) for sl in pool._slices]
    same, same_results, same_rows = _timed("resident_pool", run,
                                           pm.Mesh([first] * cards.size), budget)
    assert [list(sl) for sl in same._slices] == slices
    assert same_results == results and all(ok for ok, *_ in results.values())
    _rows_equal(rows, same_rows)
    alone, alone_results, alone_rows = _timed("resident_pool", run, pm.Mesh([first]),
                                              len(keys))
    assert alone.n_shards == 1 and len(alone) == len(keys)
    assert {k: alone_results[k] for k in results} == results
    _rows_equal(rows, {k: alone_rows[k] if rows[k] is not None else None for k in keys})
    _fresh_registry()


class _Served:
    """A serving scheduler over injected histories on `mesh`, its drain
    thread off and each flush driven by hand (tests/test_torch_serving.py's
    harness, port only)."""

    def __init__(self, hists, mesh):
        from cadence_tpu_torch.engine.persistence import Stores
        from cadence_tpu_torch.engine.serving import ServingScheduler
        from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine

        self.by_key = dict(zip(_keys(hists), hists))
        self.counts = {k: len(h) for k, h in self.by_key.items()}
        self.tpu = TPUReplayEngine(Stores(), mesh=mesh)
        self.sched = ServingScheduler(self.tpu, read_batches=self.read_batches,
                                      read_live_row=self.read_live_row)
        self.sched._ensure_thread = lambda: None

    def read_batches(self, key):
        return self.by_key[key][:self.counts[key]]

    def read_live_row(self, key):
        from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row
        from cadence_tpu_torch.oracle.state_builder import StateBuilder

        ms = StateBuilder().replay_history(self.read_batches(key))
        row = payload_row(ms, DEFAULT_LAYOUT)
        row[STICKY_ROW_INDEX] = 0
        return row, int(ms.version_histories.current_index), int(ms.execution_info.next_event_id)

    def round(self, keys):
        """Submit each key at its current count and flush once; returns
        the tickets' (ok, parity_ok, checksum, path, escalated, error) and
        the flush's serving launches."""
        from cadence_tpu_torch.engine.cache import batch_crc
        from cadence_tpu_torch.utils import metrics as m

        before = self.sched.metrics.counter(m.SCOPE_TPU_SERVING, m.M_SERVING_LAUNCHES)
        tickets = []
        for k in keys:
            row, branch, _ = self.read_live_row(k)
            tickets.append(self.sched.submit(k, row, branch,
                                             batch_crc(self.read_batches(k)[-1])))
        with self.sched._cv:
            batch = list(self.sched._pending.values())
            self.sched._pending.clear()
        self.sched._flush(batch)
        out = []
        for t in tickets:
            r = t.result(timeout=60)
            out.append((r.ok, r.parity_ok, r.checksum, r.path, r.escalated, r.error))
        launches = self.sched.metrics.counter(m.SCOPE_TPU_SERVING, m.M_SERVING_LAUNCHES) - before
        return out, launches


def test_serving_scheduler_across_cards():
    """One flush over a pool sharded across the cards: the cold admits
    launch once per owning card, then every key's suffix appends on its
    own card. The tickets' CRCs and the pool's rows equal one card's."""
    cards = _cards(2)
    hists = [h for s in ("echo_signal", "timer_retry", "basic") for h in
             generate_corpus(s, 16, seed=SEED, target_events=40)]
    keys = _keys(hists)

    def run(mesh):
        _fresh_registry()
        h = _Served(hists, mesh)
        for k in keys:
            h.counts[k] -= 2
        cold, cold_launches = h.round(keys)
        for k in keys:
            h.counts[k] += 2
        suffix, _ = h.round(keys)
        torch.cuda.synchronize()
        return h, cold, cold_launches, suffix, _pool_rows(h.tpu.resident, keys)

    h, cold, cold_launches, suffix, rows = _timed("serving_scheduler", run, cards)
    owners = {h.tpu.resident.shard_of(k) for k in keys}
    assert cold_launches == len(owners) == cards.size
    assert all(t[:2] == (True, True) and t[3] == "cold" for t in cold)
    assert all(t[:2] == (True, True) and t[3] == "suffix" for t in suffix)
    _slabs_on_their_cards(h.tpu.resident, cards)
    _, one_cold, one_launches, one_suffix, one_rows = _timed("serving_scheduler", run,
                                                             pm.Mesh([cards.devices[0]]))
    assert one_launches == 1
    assert cold == one_cold and suffix == one_suffix
    _rows_equal(rows, one_rows)
    _fresh_registry()


def _open_stores(hists, drop_tail):
    """Stores holding each history less its last `drop_tail` batches (open
    runs), each live state the oracle's; and the dropped batches."""
    from cadence_tpu_torch.engine.persistence import Stores

    stores, tails = Stores(), {}
    for h, key in zip(hists, _keys(hists)):
        kept = h[:len(h) - drop_tail]
        tails[key] = h[len(kept):]
        for b in kept:
            stores.history.append_batch(*key, list(b.events))
        _refresh(stores, key)
    return stores, tails


def _refresh(stores, key):
    from cadence_tpu_torch.oracle.state_builder import StateBuilder

    ms = StateBuilder().replay_history(stores.history.as_history_batches(*key))
    info = ms.execution_info
    info.domain_id, info.workflow_id, info.run_id = key
    stores.execution.upsert_workflow(ms)


def _oracle_row(stores, key):
    from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row

    row = payload_row(stores.execution.get_workflow(*key))
    row[STICKY_ROW_INDEX] = 0
    return row


def test_migration_hydrate_into_a_sharded_pool():
    """A host on the first card snapshots every open row and leaves; half
    the runs commit a batch before the steal; the gaining host hydrates
    every shard into a pool sharded across the cards (snapshot.seed_caches
    at the snapshot point, the suffixes replayed from the carried states on
    each owning card). The report and the rows equal a gainer on the first
    card, and each row the oracle's."""
    import dataclasses

    from cadence_tpu_torch.engine.migration import MigrationManager
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine

    cards = _cards(2)
    hists = generate_corpus("basic", 48, seed=SEED, target_events=40)
    keys, shards = _keys(hists), range(8)

    def run(mesh):
        _fresh_registry()
        stores, tails = _open_stores(hists, drop_tail=2)
        loser = TPUReplayEngine(stores, mesh=pm.Mesh([cards.devices[0]]))
        assert loser.verify_all().ok
        out = MigrationManager("h-a", 8, loser).migrate_out(shards, evict=True)
        for k in keys[::2]:  # a commit between the snapshot and the steal
            stores.history.append_batch(*k, list(tails[k][0].events))
            _refresh(stores, k)
        gainer = TPUReplayEngine(stores, mesh=mesh)
        rep = MigrationManager("h-b", 8, gainer).hydrate_shards(shards)
        torch.cuda.synchronize()
        for k in keys:
            assert np.array_equal(np.asarray(gainer.resident.entry_for(k).payload),
                                  _oracle_row(stores, k)), k
        return gainer, dataclasses.asdict(out), dataclasses.asdict(rep), \
            _pool_rows(gainer.resident, keys)

    gainer, out, rep, rows = _timed("migration_hydrate", run, cards)
    assert rep["hydrated"] == len(keys) and rep["suffix_events"] > 0
    assert rep["parity_divergence"] == 0
    _slabs_on_their_cards(gainer.resident, cards)
    _, one_out, one_rep, one_rows = _timed("migration_hydrate", run,
                                           pm.Mesh([cards.devices[0]]))
    assert out == one_out
    assert {k: v for k, v in rep.items() if not k.endswith("_s")} == \
        {k: v for k, v in one_rep.items() if not k.endswith("_s")}
    _rows_equal(rows, one_rows)
    _fresh_registry()


def test_standby_device_apply_into_a_sharded_pool():
    """The standby's device apply (engine/replication.py _DeviceApplier)
    with its pool sharded across the cards: half of each history
    replicated and the pool warmed by a verify, then the rest replicated,
    every key's suffix replayed on its owning card. The standby equals the
    active, the counters and rows equal a standby on the first card."""
    import copy

    from cadence_tpu_torch.engine import replication as R
    from cadence_tpu_torch.engine.persistence import Stores
    from cadence_tpu_torch.engine.rebuild import DeviceRebuilder
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine
    from cadence_tpu_torch.gen.fuzz import strip_new_run_events
    from cadence_tpu_torch.oracle.state_builder import StateBuilder
    from cadence_tpu_torch.utils.metrics import REPLICATION_COUNTERS, SCOPE_REPLICATION

    cards = _cards(2)
    hists = [h[:-1] for s in ("basic", "timer_retry", "echo_signal") for h in
             strip_new_run_events(generate_corpus(s, 16, seed=SEED, target_events=40))]
    keys = _keys(hists)

    def run(mesh):
        reg = _fresh_registry()
        active, standby = Stores(), Stores()
        pub = R.ReplicationPublisher(active)
        tpu = TPUReplayEngine(standby, mesh=mesh)
        proc = R.ReplicationTaskProcessor(
            R.HistoryReplicator(standby, rebuilder=DeviceRebuilder(device=cards.devices[0])),
            pub, standby, tpu=tpu)
        builders = {}

        def commit(h, batches):
            key = _keys([h])[0]
            sb = builders.setdefault(key, StateBuilder())
            for b in batches:
                active.history.append_batch(*key, list(b.events))
                sb.apply_batch(b)
                items = tuple((i.event_id, i.version)
                              for i in sb.ms.version_histories.current().items)
                pub.publish(*key, list(b.events), items)
            active.execution.upsert_workflow(copy.deepcopy(sb.ms))

        def replicate():
            while proc.process_once():
                pass

        halves = [-(-len(h) // 2) for h in hists]
        for h, n in zip(hists, halves):
            commit(h, h[:n])
        replicate()
        assert tpu.verify_all(keys).ok
        for h, n in zip(hists, halves):
            commit(h, h[n:])
        replicate()
        torch.cuda.synchronize()
        for k in keys:
            assert np.array_equal(_oracle_row(standby, k), _oracle_row(active, k)), k
            assert np.array_equal(np.asarray(tpu.resident.entry_for(k).payload),
                                  _oracle_row(active, k)), k
        counters = {n: reg.counter(SCOPE_REPLICATION, n) for n in REPLICATION_COUNTERS}
        return tpu, counters, _pool_rows(tpu.resident, keys)

    tpu, counters, rows = _timed("standby_apply", run, cards)
    assert counters["device-applied"] >= len(keys) and counters["device-parity-divergence"] == 0
    _slabs_on_their_cards(tpu.resident, cards)
    _, one_counters, one_rows = _timed("standby_apply", run, pm.Mesh([cards.devices[0]]))
    assert counters == one_counters
    _rows_equal(rows, one_rows)
    _fresh_registry()
