"""The snapshot tier's device half in the port (cadence_tpu_torch/engine/
snapshot.py: seed_caches, seed_from_batches, Snapshotter, and the engine's
snapshot_sweep) on the CPU beside the JAX package's: the non-WAL, non-CLI
cases of tests/test_snapshot.py, each run on both packages over the same
seeded histories with the outcomes and counters compared; and the gate of
the port's ROADMAP: a SnapshotRecord written by the JAX package hydrates
into the port and replays its suffix to the same CRC, and the reverse."""
import dataclasses

import numpy as np
import pytest

from cadence_tpu.core.checksum import STICKY_ROW_INDEX
from cadence_tpu_torch.core.checksum import crc32_of_row
from cadence_tpu_torch.parallel.mesh import Mesh
from tests.torch_parity import PACKAGES, package, reset_port_tiers

SNAP_COUNTERS = ("writes", "checksum-skips", "hydrates", "ignored-stale", "ignored-torn")


@pytest.fixture(autouse=True)
def _isolated():
    yield
    reset_port_tiers()


def seed_stores(pkg, stores, suite="basic", n=3, target_events=24, seed=7, cut=0):
    """Append generated histories (minus their last `cut` batches) and the
    oracle's states of them; returns (keys, histories)."""
    hists = package(pkg, "gen.corpus").generate_corpus(suite, num_workflows=n, seed=seed,
                                                       target_events=target_events)
    keys = []
    for h in hists:
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        for b in h[:len(h) - cut]:
            stores.history.append_batch(*key, list(b.events))
        upsert(pkg, stores, key)
        keys.append(key)
    return keys, hists


def upsert(pkg, stores, key):
    ms = package(pkg, "oracle.state_builder").StateBuilder().replay_history(
        stores.history.as_history_batches(*key))
    info = ms.execution_info
    info.domain_id, info.workflow_id, info.run_id = key
    stores.execution.upsert_workflow(ms)
    return ms


def engine(pkg, stores):
    eng_cls = package(pkg, "engine.tpu_engine").TPUReplayEngine
    if pkg == "cadence_tpu":
        eng = eng_cls(stores)
    else:
        eng = eng_cls(stores, mesh=Mesh(["cpu"]))
    eng.metrics = package(pkg, "utils.metrics").MetricsRegistry()
    return eng


def snap_counters(pkg, eng):
    scope = package(pkg, "utils.metrics").SCOPE_TPU_SNAPSHOT
    return tuple(eng.metrics.counter(scope, name) for name in SNAP_COUNTERS)


def stores_of(pkg):
    return package(pkg, "engine.persistence").Stores()


def report_tuple(r):
    return (r.considered, r.written, r.skipped_policy, r.skipped_checksum,
            r.skipped_not_at_tip, r.keys_written)


def test_prefix_snapshot_survives_pure_append():
    out = []
    for pkg in PACKAGES:
        stores = stores_of(pkg)
        (key,), _ = seed_stores(pkg, stores, n=1, target_events=30)
        full = stores.history.read_batches(*key)
        pre = stores_of(pkg)
        for b in full[:-1]:
            pre.history.append_batch(*key, list(b))
        upsert(pkg, pre, key)
        eng = engine(pkg, pre)
        assert eng.verify_all().ok
        report = eng.snapshot_sweep(force=True)
        pre.history.append_batch(*key, list(full[-1]))
        snap = pre.snapshot.get(key)
        out.append((report_tuple(report), snap.batch_count, snap.blob_crc,
                    snap_counters(pkg, eng)))
    assert out[0] == out[1]
    assert out[1][0][1] == 1 and out[1][1] == len(full) - 1


def test_diverged_resident_payload_refused():
    out = []
    for pkg in PACKAGES:
        stores = stores_of(pkg)
        (key,), _ = seed_stores(pkg, stores, n=1, target_events=24)
        eng = engine(pkg, stores)
        assert eng.verify_all().ok
        stores.execution.get_workflow(*key).execution_info.signal_count += 1
        out.append((report_tuple(eng.snapshot_sweep(force=True)), len(stores.snapshot),
                    snap_counters(pkg, eng)))
    assert out[0] == out[1]
    assert out[1][0][1] == 0 and out[1][0][3] == 1 and out[1][1] == 0


def test_policy_gates_due_and_min_events():
    out = []
    for pkg in PACKAGES:
        stores = stores_of(pkg)
        (key,), _ = seed_stores(pkg, stores, n=1, target_events=24)
        eng = engine(pkg, stores)
        assert eng.verify_all().ok
        snapper = package(pkg, "engine.snapshot").Snapshotter(
            stores, eng.resident, eng.pack_cache, eng.layout, registry=eng.metrics,
            min_events=10_000, every_events=4)
        seen = [snapper.due(key), snapper.snapshot_key(key)]
        snapper.min_events = 1
        seen += [snapper.snapshot_key(key), snapper.due(key)]
        snapper.note_append(key, 3)
        seen.append(snapper.due(key))
        snapper.note_append(key, 1)
        seen += [snapper.due(key), snapper.maybe_snapshot(key), snapper.due(key)]
        out.append(seen)
    assert out[0] == out[1] == [True, False, True, False, False, True, True, False]


def test_sweep_skips_entries_moved_after_their_gates(monkeypatch):
    """The serving drain may re-admit or evict a key between the sweep's
    gates and its gather (the port's entries are slab slots, not immutable
    states): such a key is counted as not at the tip and not written, and
    the sweep goes on; so does snapshot_key."""
    pkg = "cadence_tpu_torch"
    snap = package(pkg, "engine.snapshot")
    stores = stores_of(pkg)
    keys, _ = seed_stores(pkg, stores, n=3, target_events=24)
    eng = engine(pkg, stores)
    assert eng.verify_all().ok
    prepare = snap.Snapshotter._prepare

    def racing(self, key, force):
        got = prepare(self, key, force)
        entry = self.resident.entry_for(key)
        if key == keys[0]:  # re-admitted in place: a new entry owns the slot
            self.resident.admit(key, entry.address, self.resident.state_of(entry),
                                entry.payload, entry.branch)
        elif key == keys[1]:  # evicted
            self.resident.invalidate(key)
        return got

    monkeypatch.setattr(snap.Snapshotter, "_prepare", racing)
    report = eng.snapshot_sweep(force=True)
    assert (report.considered, report.written, report.skipped_not_at_tip,
            report.keys_written) == (3, 1, 2, [keys[2]])
    assert stores.snapshot.get(keys[0]) is None and stores.snapshot.get(keys[1]) is None
    assert not eng.snapshotter().snapshot_key(keys[0], force=True)
    monkeypatch.setattr(snap.Snapshotter, "_prepare", prepare)
    assert eng.snapshotter().snapshot_key(keys[0], force=True)


def with_snapshot(pkg):
    stores = stores_of(pkg)
    (key,), _ = seed_stores(pkg, stores, n=1, target_events=24)
    eng = engine(pkg, stores)
    assert eng.verify_all().ok
    assert eng.snapshot_sweep(force=True).written == 1
    eng.resident.clear()
    eng.pack_cache.clear()
    return stores, eng, key


def _torn(rec):
    rec.state_blob = rec.state_blob[:-7] + b"\x7f" * 7


def _stale(rec):
    rec.last_batch_crc ^= 0xDEAD


def _foreign(rec):
    rec.layout = tuple(v * 2 for v in rec.layout)


@pytest.mark.parametrize("doctor", [_torn, _stale, _foreign, None],
                         ids=["torn", "stale", "foreign_layout", "kill_switch"])
def test_bad_records_fall_back_to_full_replay(doctor, monkeypatch):
    out = []
    for pkg in PACKAGES:
        stores, eng, key = with_snapshot(pkg)
        if doctor is None:
            monkeypatch.setenv("CADENCE_TPU_SNAPSHOT", "0")
        else:
            doctor(stores.snapshot.get(key))
        result = eng.verify_all()
        monkeypatch.delenv("CADENCE_TPU_SNAPSHOT", raising=False)
        out.append((result.ok, result.snapshot, result.resident, snap_counters(pkg, eng)))
    assert out[0] == out[1]
    assert out[1][0] and not out[1][1] and out[1][3][2] == 0


def test_good_record_hydrates_a_fresh_pool():
    out = []
    for pkg in PACKAGES:
        stores, eng, key = with_snapshot(pkg)
        result = eng.verify_all()
        out.append((result.ok, result.snapshot, result.resident, snap_counters(pkg, eng)))
    assert out[0] == out[1] and out[1][1] == out[1][2] != []


def _chain_break(pkg, monkeypatch, cut):
    """After a restart (pool and pack cache cleared, the snapshot kept), a
    transaction with no chain serves through snapshot hydration and a
    batch-range read, the full-history read booby-trapped."""
    stores = stores_of(pkg)
    (key,), (h,) = seed_stores(pkg, stores, n=1, target_events=28, seed=13, cut=cut)
    eng = engine(pkg, stores)
    assert eng.verify_all().ok
    assert eng.snapshot_sweep(force=True).written == 1
    eng.resident.clear()
    eng.pack_cache.clear()
    if cut:
        stores.history.append_batch(*key, list(h[-1].events))
    ms = upsert(pkg, stores, key)
    full = stores.history.as_history_batches(*key)
    expected = package(pkg, "core.checksum").payload_row(ms, eng.layout)
    expected[STICKY_ROW_INDEX] = 0

    def boom(*a, **k):
        raise AssertionError("full-history read on the chain-break path")

    monkeypatch.setattr(stores.history, "read_batches", boom)
    sched = eng.serving_scheduler()
    try:
        res = sched.submit(key, expected, int(ms.version_histories.current_index),
                           package(pkg, "engine.cache").batch_crc(full[-1])).result(timeout=120)
    finally:
        sched.stop()
    return (res.ok, res.parity_ok, res.path, res.checksum, snap_counters(pkg, eng))


@pytest.mark.parametrize("cut,path", [(1, "suffix"), (0, "exact")])
def test_chain_break_served_from_the_snapshot(cut, path, monkeypatch):
    out = [_chain_break(pkg, monkeypatch, cut) for pkg in PACKAGES]
    assert out[0] == out[1]
    assert out[1][:3] == (True, True, path) and out[1][4][2] == 1


def test_snapshotted_rebuild_never_packs_the_prefix():
    out = []
    for pkg in PACKAGES:
        stores = stores_of(pkg)
        keys, hists = seed_stores(pkg, stores, n=2, target_events=26, seed=17, cut=1)
        eng = engine(pkg, stores)
        assert eng.verify_all().ok
        assert eng.snapshot_sweep(force=True).written == 2
        for h, key in zip(hists, keys):
            stores.history.append_batch(*key, list(h[-1].events))
        rb_cls = package(pkg, "engine.rebuild").DeviceRebuilder
        rb = rb_cls(eng.layout) if pkg == "cadence_tpu" else rb_cls(eng.layout, device="cpu")
        rb.snapshots = stores.snapshot
        metrics = package(pkg, "utils.metrics")
        rb.metrics = metrics.MetricsRegistry()
        rb.pack_cache.metrics = rb.metrics
        states = rb.rebuild([(stores.history.as_history_batches(*k), None) for k in keys])
        checksum = package(pkg, "core.checksum").Checksum
        sb = package(pkg, "oracle.state_builder").StateBuilder
        for key, ms in zip(keys, states):
            want = sb().replay_history(stores.history.as_history_batches(*key))
            assert checksum.of(ms).value == checksum.of(want).value
        out.append((rb.stats.snapshot_seeded, rb.stats.resident,
                    rb.metrics.counter(metrics.SCOPE_PACK_CACHE, metrics.M_CACHE_MISSES),
                    [checksum.of(ms).value for ms in states]))
    assert out[0] == out[1] and out[1][:3] == (2, 2, 0)


@pytest.mark.parametrize("writer,reader", [("cadence_tpu", "cadence_tpu_torch"),
                                           ("cadence_tpu_torch", "cadence_tpu")])
def test_records_cross_between_the_packages(writer, reader):
    """The writer's engine verifies the first batches and sweeps; its
    records go into the reader's stores, which hold the whole histories:
    the reader hydrates every record and replays the suffix to the same
    payload rows and CRCs as the writer's own engine does."""
    made = {}
    for pkg in PACKAGES:
        stores = stores_of(pkg)
        keys, hists = seed_stores(pkg, stores, suite="timer_retry", n=4, target_events=40,
                                  seed=23, cut=2)
        made[pkg] = (stores, keys, hists)
    wstores, keys, whists = made[writer]
    weng = engine(writer, wstores)
    assert weng.verify_all().ok
    assert weng.snapshot_sweep(force=True).written == 4
    rstores, rkeys, rhists = made[reader]
    assert rkeys == keys
    rec_cls = package(reader, "engine.snapshot").SnapshotRecord
    for key in keys:
        rstores.snapshot.put(rec_cls(**{f.name: getattr(wstores.snapshot.get(key), f.name)
                                        for f in dataclasses.fields(rec_cls)}))
    crcs = {}
    for pkg, stores, hists in ((writer, wstores, whists), (reader, rstores, rhists)):
        for key, h in zip(keys, hists):
            for b in h[-2:]:
                stores.history.append_batch(*key, list(b.events))
            upsert(pkg, stores, key)
    weng2, reng = engine(writer, wstores), engine(reader, rstores)
    for eng in (weng2, reng):
        result = eng.verify_all()
        assert result.ok and result.snapshot == keys and result.resident == keys
        crcs[id(eng)] = [int(crc32_of_row(np.asarray(eng.resident.entry_for(k).payload)))
                         for k in keys]
    assert crcs[id(reng)] == crcs[id(weng2)]
