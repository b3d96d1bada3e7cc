"""Shard migration in the port (cadence_tpu_torch/engine/migration.py) on
the CPU beside the JAX package's: the shapes of tests/test_migration.py
(round trip, suffix-only hydration, cold steals and stale snapshots,
closed workflows, injected divergence, shard-scoped out-migration, the
background hook, the kill switch, the routing goldens and the per-shard
execution index), each run on both packages over the same seeded
histories with the reports, counters and resident rows compared. The
controller-hook tests wait for the port's engine/controller."""
import dataclasses

import numpy as np
import pytest

from cadence_tpu_torch.parallel.mesh import Mesh
from tests.torch_parity import PACKAGES, package, reset_port_tiers

NUM_SHARDS = 4


@pytest.fixture(autouse=True)
def _isolated():
    yield
    reset_port_tiers()


def engine(pkg, stores):
    eng_cls = package(pkg, "engine.tpu_engine").TPUReplayEngine
    eng = eng_cls(stores) if pkg == "cadence_tpu" else eng_cls(stores, mesh=Mesh(["cpu"]))
    eng.metrics = package(pkg, "utils.metrics").MetricsRegistry()
    return eng


def manager(pkg, host, tpu):
    return package(pkg, "engine.migration").MigrationManager(host, NUM_SHARDS, tpu)


def refresh(pkg, stores, key):
    ms = package(pkg, "oracle.state_builder").StateBuilder().replay_history(
        stores.history.as_history_batches(*key))
    info = ms.execution_info
    info.domain_id, info.workflow_id, info.run_id = key
    stores.execution.upsert_workflow(ms)


def oracle_row(pkg, stores, key):
    checksum = package(pkg, "core.checksum")
    row = checksum.payload_row(stores.execution.get_workflow(*key))
    row[checksum.STICKY_ROW_INDEX] = 0
    return row


def seed_open(pkg, n=4, target_events=30, drop_tail=2, seed=7, suite="basic"):
    """(stores, keys, tails): generated histories without their last
    `drop_tail` batches (open workflows), the dropped batches by key."""
    stores = package(pkg, "engine.persistence").Stores()
    hists = package(pkg, "gen.corpus").generate_corpus(suite, num_workflows=n, seed=seed,
                                                       target_events=target_events)
    keys, tails = [], {}
    for h in hists:
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        kept = h[:len(h) - drop_tail]
        tails[key] = h[len(kept):]
        for b in kept:
            stores.history.append_batch(*key, list(b.events))
        refresh(pkg, stores, key)
        keys.append(key)
    return stores, keys, tails


def rows_of(tpu, keys):
    return {k: (None if tpu.resident.entry_for(k) is None
                else (np.asarray(tpu.resident.entry_for(k).payload),
                      int(tpu.resident.entry_for(k).branch))) for k in keys}


def assert_rows_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert got[k] is not None and np.array_equal(got[k][0], want[k][0]), k
            assert got[k][1] == want[k][1], k


def both(fn):
    """fn(pkg) on each package; the outcomes (reports as dicts, row maps)."""
    return [fn(pkg) for pkg in PACKAGES]


def report(r):
    return dataclasses.asdict(r)


# ---------------------------------------------------------------------------
# routing goldens: the host-shard and device-shard hash paths
# ---------------------------------------------------------------------------

HOST_GOLDENS = {
    "wf-0": [0, 1, 1, 9, 361], "wf-1": [0, 3, 3, 11, 875], "order-12345": [0, 2, 2, 10, 42],
    "lg-victim-pool-3": [0, 2, 6, 14, 590], "a": [0, 1, 5, 5, 117], "": [0, 0, 4, 12, 636],
}
DEVICE_GOLDENS = {
    ("d", "wf-0", "r1"): [0, 1, 1, 5], ("dom", "order-12345", "run-7"): [0, 1, 1, 5],
    ("d2", "lg-victim-pool-3", "r"): [0, 1, 3, 3],
}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_routing_goldens(pkg):
    """tests/test_migration.py's goldens hold in both packages: the host
    shard hashes the workflow id, the mesh position the full run key."""
    shard_id = package(pkg, "engine.membership").shard_id_for_workflow
    workflow_shard = package(pkg, "parallel.mesh").workflow_shard
    for wf, want in HOST_GOLDENS.items():
        assert [shard_id(wf, n) for n in (1, 4, 8, 16, 1024)] == want
    for key, want in DEVICE_GOLDENS.items():
        assert [workflow_shard(key, n) for n in (1, 2, 4, 8)] == want
    assert len({workflow_shard(("d", "wf-0", f"r{i}"), 8) for i in range(64)}) > 1


# ---------------------------------------------------------------------------
# the migration round trip
# ---------------------------------------------------------------------------

def test_out_then_hydrate_exact_byte_parity():
    """A planned rebalance with no traffic between: every row hydrates at
    the snapshot point, no suffix, rows equal to the oracle's and to the
    JAX package's."""
    def run(pkg):
        stores, keys, _ = seed_open(pkg)
        loser = engine(pkg, stores)
        assert loser.verify_all().ok
        out = manager(pkg, "h-a", loser).migrate_out(range(NUM_SHARDS), evict=True)
        assert len(loser.resident) == 0
        gainer = engine(pkg, stores)
        rep = manager(pkg, "h-b", gainer).hydrate_shards(range(NUM_SHARDS))
        for key in keys:
            assert np.array_equal(np.asarray(gainer.resident.entry_for(key).payload),
                                  oracle_row(pkg, stores, key))
        return report(out), report(rep), rows_of(gainer, keys)

    (t_out, t_rep, t_rows), (j_out, j_rep, j_rows) = both(run)
    assert t_out == j_out and t_out["snapshotted"] == 4 and t_out["skipped"] == 0
    assert t_rep == j_rep and t_rep["hydrated"] == 4 and t_rep["suffix_events"] == 0
    assert_rows_equal(t_rows, j_rows)


def test_hydrate_replays_only_the_appended_suffix():
    """A commit between the snapshot and the steal: hydration seeds at the
    snapshot point and replays only the new batches; the next verify
    serves every key from the pool."""
    def run(pkg):
        stores, keys, tails = seed_open(pkg)
        loser = engine(pkg, stores)
        assert loser.verify_all().ok
        manager(pkg, "h-a", loser).migrate_out(range(NUM_SHARDS))
        for key in keys:
            stores.history.append_batch(*key, list(tails[key][0].events))
            refresh(pkg, stores, key)
        gainer = engine(pkg, stores)
        rep = manager(pkg, "h-b", gainer).hydrate_shards(range(NUM_SHARDS))
        rows = rows_of(gainer, keys)
        for key in keys:
            assert np.array_equal(rows[key][0], oracle_row(pkg, stores, key))
        res = gainer.verify_all()
        assert res.ok and len(res.resident) == len(keys)
        return report(rep), rows

    (t_rep, t_rows), (j_rep, j_rows) = both(run)
    assert t_rep == j_rep and t_rep["hydrated"] == 4 and t_rep["suffix_events"] > 0
    assert t_rep["parity_divergence"] == 0
    assert_rows_equal(t_rows, j_rows)


def test_cold_steal_and_stale_snapshot_counted():
    """No record: a cold steal; a record whose boundary CRC no longer
    matches the stored bytes: stale, never served."""
    def run(pkg):
        stores, keys, _ = seed_open(pkg, n=3)
        loser = engine(pkg, stores)
        assert loser.verify_all().ok
        manager(pkg, "h-a", loser).migrate_out(range(NUM_SHARDS))
        stores.snapshot.drop(keys[0])
        stores.snapshot.get(keys[1]).last_batch_crc ^= 0x5A5A5A5A
        gainer = engine(pkg, stores)
        mgr = manager(pkg, "h-b", gainer)
        rep = mgr.hydrate_shards(range(NUM_SHARDS))
        return report(rep), rows_of(gainer, keys), mgr.stats()

    (t_rep, t_rows, t_stats), (j_rep, j_rows, j_stats) = both(run)
    assert t_rep == j_rep
    assert (t_rep["cold"], t_rep["stale"], t_rep["hydrated"]) == (1, 1, 1)
    assert_rows_equal(t_rows, j_rows)
    assert sum(v is None for v in t_rows.values()) == 2
    assert t_stats == j_stats


def test_young_steal_counted_apart():
    """A record-less key with at most YOUNG_BATCHES batches is a young
    steal, not a cold one."""
    def run(pkg):
        stores, keys, _ = seed_open(pkg, n=2, target_events=30, drop_tail=0)
        young = ("young-d", "young-wf", "young-run")
        h = package(pkg, "gen.corpus").generate_history("basic", 3, 9, 20)
        for b in h[:2]:
            stores.history.append_batch(*young, list(b.events))
        refresh(pkg, stores, young)
        rep = manager(pkg, "h-b", engine(pkg, stores)).hydrate_shards(range(NUM_SHARDS))
        return report(rep)

    t_rep, j_rep = both(run)
    assert t_rep == j_rep and t_rep["young"] == 1


def test_closed_workflows_skipped():
    def run(pkg):
        stores = package(pkg, "engine.persistence").Stores()
        for h in package(pkg, "gen.corpus").generate_corpus("basic", num_workflows=2, seed=9,
                                                            target_events=24):
            key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
            for b in h:
                stores.history.append_batch(*key, list(b.events))
            refresh(pkg, stores, key)
        loser = engine(pkg, stores)
        assert loser.verify_all().ok
        manager(pkg, "h-a", loser).migrate_out(range(NUM_SHARDS))
        return report(manager(pkg, "h-b", engine(pkg, stores)).hydrate_shards(range(NUM_SHARDS)))

    t_rep, j_rep = both(run)
    assert t_rep == j_rep
    assert t_rep["skipped_closed"] == 2 and t_rep["hydrated"] == 0


def test_hydration_parity_divergence_dropped_and_counted():
    """A record whose payload lies (a change the blob CRC does not cover)
    is caught against the oracle at hydration, dropped and counted."""
    def run(pkg):
        m = package(pkg, "utils.metrics")
        stores, keys, _ = seed_open(pkg, n=1)
        loser = engine(pkg, stores)
        assert loser.verify_all().ok
        manager(pkg, "h-a", loser).migrate_out(range(NUM_SHARDS))
        rec = stores.snapshot.get(keys[0])
        rec.payload = np.array(rec.payload, copy=True)
        rec.payload[3] += 1
        gainer = engine(pkg, stores)
        rep = manager(pkg, "h-b", gainer).hydrate_shards(range(NUM_SHARDS))
        assert gainer.resident.entry_for(keys[0]) is None
        return report(rep), gainer.metrics.counter(m.SCOPE_TPU_MIGRATION, m.M_MIG_DIVERGENCE)

    (t_rep, t_div), (j_rep, j_div) = both(run)
    assert t_rep == j_rep and t_rep["parity_divergence"] == 1 and t_rep["hydrated"] == 0
    assert t_div == j_div == 1


def test_shard_scoped_out_migration():
    """migrate_out moves only the named shards' rows; the rest stay."""
    def run(pkg):
        stores, keys, _ = seed_open(pkg, n=6, seed=11)
        tpu = engine(pkg, stores)
        assert tpu.verify_all().ok
        mgr = manager(pkg, "h-a", tpu)
        moved = sorted({mgr.shard_of(k) for k in keys})[0]
        out = mgr.migrate_out([moved], evict=True)
        for key in keys:
            if mgr.shard_of(key) == moved:
                assert tpu.resident.entry_for(key) is None
                assert stores.snapshot.get(key) is not None
            else:
                assert tpu.resident.entry_for(key) is not None
        checksums = package(pkg, "engine.migration").resident_row_checksums(tpu.resident)
        return report(out), checksums

    (t_out, t_sums), (j_out, j_sums) = both(run)
    assert t_out == j_out and t_out["evicted"] == t_out["considered"] > 0
    assert t_sums == j_sums


def test_drain_host_keeps_entries():
    """The drain verb snapshots every resident row and keeps serving."""
    def run(pkg):
        stores, keys, _ = seed_open(pkg, n=3, seed=5)
        tpu = engine(pkg, stores)
        assert tpu.verify_all().ok
        out = manager(pkg, "h-a", tpu).drain_host()
        assert all(tpu.resident.entry_for(k) is not None for k in keys)
        assert all(stores.snapshot.get(k) is not None for k in keys)
        return report(out)

    t_out, j_out = both(run)
    assert t_out == j_out and t_out["snapshotted"] == 3 and t_out["evicted"] == 0


def test_background_hook_hydrates_and_drains():
    def run(pkg):
        stores, keys, _ = seed_open(pkg, n=2, seed=13)
        loser = engine(pkg, stores)
        assert loser.verify_all().ok
        manager(pkg, "h-a", loser).migrate_out(range(NUM_SHARDS))
        mgr = manager(pkg, "h-b", engine(pkg, stores))
        mgr.shards_acquired(range(NUM_SHARDS))
        assert mgr.drain(timeout=120.0)
        return report(mgr.last_in)

    t_in, j_in = both(run)
    assert t_in == j_in and t_in["hydrated"] == 2


def test_kill_switch_disables_both_directions(monkeypatch):
    monkeypatch.setenv("CADENCE_TPU_MIGRATION", "0")

    def run(pkg):
        stores, keys, _ = seed_open(pkg, n=1, seed=15)
        tpu = engine(pkg, stores)
        assert tpu.verify_all().ok
        mgr = manager(pkg, "h-a", tpu)
        out = mgr.shards_released(list(range(NUM_SHARDS)))
        assert len(stores.snapshot) == 0 and tpu.resident.entry_for(keys[0]) is not None
        mgr.shards_acquired(range(NUM_SHARDS))
        assert mgr.drain(timeout=10.0)
        return report(out), report(mgr.last_in), mgr.stats()

    t, j = both(run)
    assert t == j
    assert t[0]["snapshotted"] == 0 and t[1]["considered"] == 0 and not t[2]["enabled"]


def test_hydration_with_no_device_named_means_the_card(monkeypatch):
    """No fallback: an engine with no device named hydrates on the card,
    and without one the pass raises instead of carrying on on the CPU."""
    import torch

    from cadence_tpu_torch.engine.migration import MigrationManager
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine

    stores, _keys, _ = seed_open("cadence_tpu_torch", n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        MigrationManager("h-b", NUM_SHARDS, TPUReplayEngine(stores)).hydrate_shards([0, 1])


# ---------------------------------------------------------------------------
# the per-shard execution index hydration reads
# ---------------------------------------------------------------------------

def seed_index(pkg, n=24, num_shards=8):
    shard_id = package(pkg, "engine.membership").shard_id_for_workflow
    stores = package(pkg, "engine.persistence").Stores()
    expected = {}
    for i in range(n):
        ms = package(pkg, "oracle.mutable_state").MutableState()
        info = ms.execution_info
        info.domain_id, info.workflow_id, info.run_id = "idx-d", f"idx-wf-{i}", f"r-{i}"
        stores.execution.upsert_workflow(ms)
        expected.setdefault(shard_id(info.workflow_id, num_shards), set()).add(
            ("idx-d", info.workflow_id, info.run_id))
    return stores, expected


@pytest.mark.parametrize("pkg", PACKAGES)
def test_shard_index_matches_the_filter(pkg):
    stores, expected = seed_index(pkg)
    for shard, keys in expected.items():
        got = stores.execution.list_executions_for_shards([shard], 8)
        assert set(got) == keys and got == sorted(got)


def test_migration_hydration_uses_the_index(monkeypatch):
    """hydrate_shards reads the per-shard index, never list_executions, and
    considers what the JAX package considers."""
    def run(pkg):
        stores, expected = seed_index(pkg, n=6, num_shards=4)

        def boom():
            raise AssertionError("hydration walked list_executions")

        monkeypatch.setattr(stores.execution, "list_executions", boom, raising=False)
        rep = package(pkg, "engine.migration").MigrationManager(
            "h-idx", 4, engine(pkg, stores)).hydrate_shards([0, 1])
        assert rep.considered == len(expected.get(0, ())) + len(expected.get(1, ()))
        return report(rep)

    t_rep, j_rep = both(run)
    assert t_rep == j_rep


def test_migration_counters_preregistered_with_the_jax_names():
    from cadence_tpu.utils import metrics as jm
    from cadence_tpu_torch.utils import metrics as tm

    reg = tm.MetricsRegistry()
    tm.preregister_migration(reg)
    got = reg.snapshot()[tm.SCOPE_TPU_MIGRATION]
    assert tm.SCOPE_TPU_MIGRATION == jm.SCOPE_TPU_MIGRATION
    assert got == {getattr(jm, n): 0 for n in dir(jm) if n.startswith("M_MIG_")}
