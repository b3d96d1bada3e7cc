"""Cross-cluster replication in the port (cadence_tpu_torch/engine/
replication.py) on the CPU beside the JAX package's, over pairs of Stores
(an active side with a ReplicationPublisher, a standby behind a
ReplicationTaskProcessor): the store-level shapes of tests/test_replication.py
(dedupe, gap resend, the DLQ with its redrive and merge, backpressure,
shipped snapshots, the device standby apply and its kill switch) and an NDC
conflict, each run on both packages with the counters, the standby's
states and the resident rows compared. The tests that need the Onebox
(`clusters`, failover) wait for the port's engine/multicluster."""
import copy

import numpy as np
import pytest

from cadence_tpu_torch.parallel.mesh import Mesh
from tests.torch_parity import PACKAGES, package, reset_port_tiers


@pytest.fixture(autouse=True)
def _isolated():
    yield
    reset_port_tiers()


class Pair:
    """An active Stores publishing into its replication queue and a standby
    Stores draining it, in package `pkg` (the standby's engine on the CPU
    when `tpu`)."""

    def __init__(self, pkg, tpu=True, reader=True):
        self.pkg = pkg
        P = lambda mod: package(pkg, mod)  # noqa: E731
        self.R = P("engine.replication")
        self.m = P("utils.metrics")
        Stores = P("engine.persistence").Stores
        self.active, self.standby = Stores(), Stores()
        self.pub = self.R.ReplicationPublisher(self.active)
        self.reg = self.m.MetricsRegistry()
        self.tpu = None
        if tpu:
            eng_cls = P("engine.tpu_engine").TPUReplayEngine
            self.tpu = (eng_cls(self.standby) if pkg == "cadence_tpu"
                        else eng_cls(self.standby, mesh=Mesh(["cpu"])))
            self.tpu.metrics = self.reg
        rb_cls = P("engine.rebuild").DeviceRebuilder
        rebuilder = rb_cls() if pkg == "cadence_tpu" else rb_cls(device="cpu")
        self.proc = self.R.ReplicationTaskProcessor(
            self.R.HistoryReplicator(self.standby, rebuilder=rebuilder), self.pub, self.standby,
            source_history_reader=self.read_active if reader else None, tpu=self.tpu)
        self.proc.metrics = self.reg
        self.builders = {}

    def read_active(self, domain_id, workflow_id, run_id, from_event_id, to_event_id):
        batches = self.active.history.as_history_batches(domain_id, workflow_id, run_id)
        return [b for b in batches if from_event_id <= b.events[0].id < to_event_id]

    def commit(self, h, batches):
        """Append `batches` of history `h` on the active side (its live state
        the oracle's) and publish each with its branch's version history."""
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        sb = self.builders.setdefault(key, package(self.pkg, "oracle.state_builder").StateBuilder())
        for b in batches:
            self.active.history.append_batch(*key, list(b.events))
            sb.apply_batch(b)
            items = tuple((i.event_id, i.version) for i in sb.ms.version_histories.current().items)
            self.pub.publish(*key, list(b.events), items)
        self.active.execution.upsert_workflow(copy.deepcopy(sb.ms))
        return key

    def replicate(self):
        total = 0
        while True:
            n = self.proc.process_once()
            total += n
            if n == 0:
                return total

    def counters(self):
        """Every replication counter by name (the two packages' names are
        the same) and the DLQ depth gauge."""
        from cadence_tpu_torch.utils.metrics import REPLICATION_COUNTERS

        out = {n: self.reg.counter(self.m.SCOPE_REPLICATION, n) for n in REPLICATION_COUNTERS}
        out["dlq-depth"] = self.reg.gauge_value(self.m.SCOPE_REPLICATION, "dlq-depth")
        return out

    def standby_row(self, key):
        checksum = package(self.pkg, "core.checksum")
        row = checksum.payload_row(self.standby.execution.get_workflow(*key))
        row[checksum.STICKY_ROW_INDEX] = 0
        return row

    def active_row(self, key):
        checksum = package(self.pkg, "core.checksum")
        row = checksum.payload_row(self.active.execution.get_workflow(*key))
        row[checksum.STICKY_ROW_INDEX] = 0
        return row

    def events(self, stores, key):
        return [(e.id, int(e.event_type), e.version) for e in stores.history.read_events(*key)]

    def resident_rows(self, keys):
        out = {}
        for k in keys:
            e = self.tpu.resident.entry_for(k)
            out[k] = None if e is None else (np.asarray(e.payload), int(e.branch))
        return out

    def processor_counts(self):
        p = self.proc
        return (p.ack_index, p.applied, p.deduped, p.resends, p.snapshots_installed, p.sheds)


def open_histories(pkg, n=4, suite="echo_signal", seed=5, target_events=30):
    """Store-shaped histories without their last batch: the runs stay open."""
    gen = package(pkg, "gen.corpus").generate_corpus(suite, num_workflows=n, seed=seed,
                                                     target_events=target_events)
    return [h[:-1] for h in package(pkg, "gen.fuzz").strip_new_run_events(gen)]


def assert_same(t, j):
    """Two packages' outcomes: equal, with numpy arrays compared exactly."""
    if isinstance(t, dict):
        assert sorted(t, key=repr) == sorted(j, key=repr)
        for k in t:
            assert_same(t[k], j[k])
    elif isinstance(t, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            assert_same(a, b)
    elif isinstance(t, np.ndarray):
        assert np.array_equal(t, j)
    else:
        assert t == j


def both(fn):
    t, j = (fn(pkg) for pkg in PACKAGES)
    assert_same(t, j)
    return t


def test_standby_state_matches_active():
    """Every batch crosses: the standby's histories and states equal the
    active's, as in the JAX package."""
    def run(pkg):
        pair = Pair(pkg, tpu=False)
        keys = [pair.commit(h, h) for h in open_histories(pkg)]
        applied = pair.replicate()
        for key in keys:
            assert np.array_equal(pair.active_row(key), pair.standby_row(key))
            assert pair.events(pair.active, key) == pair.events(pair.standby, key)
        return applied, pair.processor_counts(), pair.counters()

    applied, counts, _ = both(run)
    assert applied > 0 and counts[1] == applied


def test_duplicate_delivery_deduped():
    def run(pkg):
        pair = Pair(pkg, tpu=False)
        for h in open_histories(pkg, n=2):
            pair.commit(h, h)
        pair.replicate()
        pair.proc.ack_index = 0  # at-least-once: the whole stream again
        pair.replicate()
        return pair.processor_counts(), pair.counters()

    counts, counters = both(run)
    assert counts[2] == counts[1] > 0


def test_gap_triggers_resend():
    """Tasks skipped mid-stream: the resender pulls the missing range."""
    def run(pkg):
        pair = Pair(pkg, tpu=False)
        keys = [pair.commit(h, h) for h in open_histories(pkg, n=2)]
        pair.proc.ack_index = 3
        pair.replicate()
        for key in keys:
            assert np.array_equal(pair.active_row(key), pair.standby_row(key))
        return pair.processor_counts(), pair.counters()

    counts, _ = both(run)
    assert counts[3] >= 1


def poison(pair, key):
    """A contiguous batch the standby's replicator must reject."""
    codec = package(pair.pkg, "core.codec")
    events = package(pair.pkg, "core.events")
    ET = package(pair.pkg, "core.enums").EventType
    ms = pair.standby.execution.get_workflow(*key)
    next_id = ms.execution_info.next_event_id
    version = ms.version_histories.current().last_item().version
    bad = events.HistoryBatch(domain_id=key[0], workflow_id=key[1], run_id=key[2], events=[
        events.HistoryEvent(id=next_id, event_type=ET.ActivityTaskCompleted, version=version,
                            timestamp=1, attrs=dict(scheduled_event_id=9999,
                                                    started_event_id=9998))])
    pair.active.queue.enqueue(pair.R.REPLICATION_QUEUE, pair.R.ReplicationTask(
        domain_id=key[0], workflow_id=key[1], run_id=key[2], first_event_id=next_id,
        next_event_id=next_id + 1, version=version,
        events_blob=codec.serialize_history([bad])))


def test_gap_without_a_reader_quarantines():
    def run(pkg):
        pair = Pair(pkg, tpu=False, reader=False)
        for h in open_histories(pkg, n=1):
            pair.commit(h, h)
        pair.proc.ack_index = 2
        pair.replicate()
        return pair.processor_counts(), pair.proc.dlq_summary(), pair.counters()

    counts, summary, _ = both(run)
    assert summary["depth"] > 0


def test_poison_task_dlq_summary_and_redrive():
    """A poison batch lands in the DLQ (depth gauge, rollup); a redrive
    re-quarantines it; merge applies nothing."""
    def run(pkg):
        pair = Pair(pkg, tpu=False)
        keys = [pair.commit(h, h) for h in open_histories(pkg, n=1)]
        pair.replicate()
        poison(pair, keys[0])
        pair.replicate()
        summary = pair.proc.dlq_summary()
        assert "missing activity" in summary["oldest"]["error"]
        gauge = pair.counters()[pair.m.M_REPL_DLQ_DEPTH]
        return summary, gauge, pair.proc.redrive_dlq(), pair.proc.merge_dlq(), pair.counters()

    summary, gauge, redrive, merged, _ = both(run)
    assert summary["depth"] == 1 and gauge == 1.0
    assert redrive == {"read": 1, "redriven": 0, "requeued": 1} and merged == 0


def test_redrive_clears_healed_entries():
    def run(pkg):
        pair = Pair(pkg, tpu=False)
        for h in open_histories(pkg, n=1):
            pair.commit(h, h)
        pair.replicate()
        _, applied_task = pair.active.queue.read(pair.R.REPLICATION_QUEUE, 0, 1)[0]
        pair.standby.queue.enqueue(pair.R.REPLICATION_DLQ, pair.R.DLQEntry(
            task=applied_task, error="transient: peer flapped"))
        out = pair.proc.redrive_dlq()
        assert pair.proc.read_dlq() == []
        return out, pair.counters()

    out, counters = both(run)
    assert out == {"read": 1, "redriven": 1, "requeued": 0}


def test_over_budget_pass_sheds_typed_and_resumes():
    def run(pkg):
        pair = Pair(pkg, tpu=False)
        keys = [pair.commit(h, h) for h in open_histories(pkg, n=1)]
        backlog = pair.active.queue.size(pair.R.REPLICATION_QUEUE)
        pair.proc.domain_budget = 2
        first = pair.proc.process_once()
        shed = pair.proc.last_shed
        assert isinstance(shed, pair.R.ReplicationBackpressureShed)
        total = first + pair.replicate()
        assert total == backlog and pair.proc.last_shed is None
        assert np.array_equal(pair.active_row(keys[0]), pair.standby_row(keys[0]))
        return first, (shed.domain_id, shed.applied, shed.deferred), pair.counters()

    first, shed, counters = both(run)
    assert first == 2 and shed[1] == 2


def test_raise_on_shed_and_zero_budget():
    def run(pkg):
        pair = Pair(pkg, tpu=False)
        for h in open_histories(pkg, n=1):
            pair.commit(h, h)
        pair.proc.domain_budget = 1
        with pytest.raises(pair.R.ReplicationBackpressureShed) as exc:
            pair.proc.process_once(raise_on_shed=True)
        pair.proc.domain_budget = 0
        rest = pair.proc.process_once()
        return exc.value.applied, exc.value.deferred, rest, pair.proc.sheds

    applied, deferred, rest, sheds = both(run)
    assert applied == 1 and rest == deferred and sheds == 1


def test_env_sets_default_budget(monkeypatch):
    def run(pkg):
        R = package(pkg, "engine.replication")
        monkeypatch.setenv(R.DOMAIN_BUDGET_ENV, "7")
        seven = Pair(pkg, tpu=False).proc.domain_budget
        monkeypatch.setenv(R.DOMAIN_BUDGET_ENV, "bogus")
        return seven, Pair(pkg, tpu=False).proc.domain_budget, R.DEFAULT_DOMAIN_BUDGET

    seven, bogus, default = both(run)
    assert seven == 7 and bogus == default == 256


def test_torn_stale_foreign_shipped_snapshots_ignored():
    def run(pkg):
        import zlib

        snap = package(pkg, "engine.snapshot")
        pair = Pair(pkg)
        keys = [pair.commit(h, h) for h in open_histories(pkg, n=1)]
        pair.replicate()
        blob = b"shipped-state"
        base = dict(key=keys[0], batch_count=1, last_batch_crc=0xBAD, events=4,
                    history_size=64, branch=0, payload=np.zeros(8, dtype=np.int64),
                    state_blob=blob, blob_crc=zlib.crc32(blob), interner={},
                    layout=snap.layout_signature(pair.tpu.layout))
        torn = snap.SnapshotRecord(**{**base, "blob_crc": base["blob_crc"] ^ 1})
        foreign_version = snap.SnapshotRecord(**base)
        foreign_version.version = 999
        foreign_layout = snap.SnapshotRecord(**{**base, "layout": (7, 7, 7)})
        stale = snap.SnapshotRecord(**base)
        for rec in (torn, foreign_version, foreign_layout, stale):
            pair.pub.publish_snapshot(rec, "primary")
        pair.replicate()
        assert pair.standby.snapshot.get(keys[0]) is None
        return pair.counters(), pair.processor_counts()

    counters, counts = both(run)
    assert counters["snapshots-shipped"] == 4 and counters["snapshots-ignored-torn"] == 1
    assert counters["snapshots-ignored-foreign"] == 2 and counters["snapshots-ignored-stale"] == 1
    assert counts[4] == 0


def half_then_rest(pair, hists, warm=True, ship=0):
    """Publish and drain the first half of each history, warm the standby's
    pool through verify_all (all but the first `ship` keys), ship those
    keys' snapshots from an active engine, then publish and drain the rest."""
    halves = [-(-len(h) // 2) for h in hists]
    keys = [pair.commit(h, h[:n]) for h, n in zip(hists, halves)]
    pair.replicate()
    if warm:
        assert pair.tpu.verify_all(keys[ship:]).ok
    if ship:
        eng_cls = package(pair.pkg, "engine.tpu_engine").TPUReplayEngine
        source = (eng_cls(pair.active) if pair.pkg == "cadence_tpu"
                  else eng_cls(pair.active, mesh=Mesh(["cpu"])))
        source.metrics = package(pair.pkg, "utils.metrics").MetricsRegistry()
        source.snapshotter().shipper = lambda rec: pair.pub.publish_snapshot(rec, "primary")
        assert source.verify_all(keys[:ship]).ok
        assert all(source.snapshotter().snapshot_key(k, force=True) for k in keys[:ship])
    for h, n in zip(hists, halves):
        pair.commit(h, h[n:])
    pair.replicate()
    return keys


def test_device_apply_finishes_suffixes_with_the_jax_counts_and_rows():
    """The standby's device apply: cold before the pool is warm, then every
    open key replays its suffix from its resident state; the counters and
    the resident rows equal the JAX package's, and the oracle's."""
    def run(pkg):
        pair = Pair(pkg)
        hists = (open_histories(pkg, n=3, suite="basic", seed=2)
                 + open_histories(pkg, n=3, suite="timer_retry", seed=2))
        keys = half_then_rest(pair, hists)
        rows = pair.resident_rows(keys)
        for key in keys:
            assert np.array_equal(rows[key][0], pair.active_row(key))
            assert np.array_equal(pair.active_row(key), pair.standby_row(key))
        return pair.counters(), rows, pair.processor_counts()

    counters, rows, _ = both(run)
    assert counters["device-applied"] == 6 and counters["device-skipped-cold"] == 6
    assert counters["device-parity-divergence"] == 0 and counters["device-suffix-events"] > 0


def test_shipped_snapshot_seeds_the_device_apply():
    """Shipped records install on the standby; the next drain seeds those
    keys from them and replays only their suffixes."""
    def run(pkg):
        pair = Pair(pkg)
        keys = half_then_rest(pair, open_histories(pkg, n=4, suite="concurrent_child", seed=3),
                              ship=2)
        return pair.counters(), pair.resident_rows(keys), pair.processor_counts()

    counters, rows, counts = both(run)
    assert counters["snapshots-installed"] == 2 and counts[4] == 2
    assert counters["device-applied"] == 4 and counters["device-parity-divergence"] == 0


def test_cold_keys_stay_host_only():
    """No resident entry and no shipped snapshot: the device counts the keys
    cold and the host path stays complete."""
    def run(pkg):
        pair = Pair(pkg)
        keys = half_then_rest(pair, open_histories(pkg, n=2, seed=7), warm=False)
        for key in keys:
            assert pair.events(pair.active, key) == pair.events(pair.standby, key)
            assert pair.tpu.resident.entry_for(key) is None
        return pair.counters()

    counters = both(run)
    assert counters["device-skipped-cold"] == 4 and counters["device-applied"] == 0


def test_kill_switch_restores_host_only_path(monkeypatch):
    """CADENCE_TPU_REPL_DEVICE=0: no device work in the drain, the same host
    apply."""
    from cadence_tpu_torch.ops import _build

    def run(pkg):
        monkeypatch.setenv(package(pkg, "engine.replication").ENABLE_DEVICE_ENV, "0")
        pair = Pair(pkg)
        hists = open_histories(pkg, n=2, seed=9)
        halves = [-(-len(h) // 2) for h in hists]
        keys = [pair.commit(h, h[:n]) for h, n in zip(hists, halves)]
        pair.replicate()
        assert pair.tpu.verify_all(keys).ok
        for h, n in zip(hists, halves):
            pair.commit(h, h[n:])
        _build.reset_launches()
        pair.replicate()
        assert not any(_build.launches.values())
        for key in keys:
            assert np.array_equal(pair.active_row(key), pair.standby_row(key))
        return pair.counters(), pair.resident_rows(keys)

    counters, _rows = both(run)
    assert counters["device-applied"] == counters["device-skipped-cold"] == 0


def test_closed_runs_leave_the_pool():
    """A drain that closes a run drops its resident entry: closed runs take
    no more transactions."""
    def run(pkg):
        pair = Pair(pkg)
        gen = package(pkg, "gen.corpus").generate_corpus("echo_signal", num_workflows=2, seed=4,
                                                         target_events=30)
        hists = package(pkg, "gen.fuzz").strip_new_run_events(gen)
        keys = half_then_rest(pair, hists)
        return pair.counters(), pair.resident_rows(keys)

    counters, rows = both(run)
    assert all(v is None for v in rows.values()) and counters["device-applied"] == 0


def test_ndc_conflict_rebuilds_and_stays_host_only():
    """A higher-version batch forking below the standby's tip: the replicator
    forks, the conflict rebuild (the device rebuilder) makes the winner
    current, and the device apply leaves the branching key to the host."""
    def run(pkg):
        pair = Pair(pkg)
        events = package(pkg, "core.events")
        codec = package(pkg, "core.codec")
        ET = package(pkg, "core.enums").EventType
        hists = open_histories(pkg, n=1, seed=11)
        keys = half_then_rest(pair, hists)
        key = keys[0]
        ms = pair.standby.execution.get_workflow(*key)
        tip = ms.execution_info.next_event_id - 1
        version = ms.version_histories.current().last_item().version
        fork_at = tip - 2
        sig = [events.HistoryEvent(id=fork_at + 1, event_type=ET.WorkflowExecutionSignaled,
                                   version=version + 100, timestamp=10**12, task_id=9000,
                                   attrs={"signal_name": "ndc-winner"})]
        batch = events.HistoryBatch(domain_id=key[0], workflow_id=key[1], run_id=key[2],
                                    events=sig)
        pair.active.queue.enqueue(pair.R.REPLICATION_QUEUE, pair.R.ReplicationTask(
            domain_id=key[0], workflow_id=key[1], run_id=key[2], first_event_id=fork_at + 1,
            next_event_id=fork_at + 2, version=version + 100,
            events_blob=codec.serialize_history([batch]),
            version_history_items=((fork_at, version), (fork_at + 1, version + 100))))
        pair.replicate()
        assert pair.standby.history.branch_count(*key) == 2
        assert pair.standby.history.get_current_branch(*key) == 1
        assert pair.tpu.resident.entry_for(key) is None
        return pair.counters(), pair.standby_row(key), pair.processor_counts()

    counters, _row, _ = both(run)
    assert counters["device-skipped-cold"] == 2


def test_sync_activity_replicates_transient_attempts():
    """A SyncActivity task overwrites the standby's pending activity's
    transient state; an older attempt is dropped."""
    def run(pkg):
        pair = Pair(pkg, tpu=False)
        h = open_histories(pkg, n=1, suite="basic", seed=6)[0]
        sb = package(pkg, "oracle.state_builder").StateBuilder()
        cut = 0
        while not sb.ms.pending_activity_info_ids:  # the first batch that leaves one pending
            sb.apply_batch(h[cut])
            cut += 1
        key = pair.commit(h, h[:cut])
        pair.replicate()
        ms = pair.active.execution.get_workflow(*key)
        ai = copy.deepcopy(next(iter(ms.pending_activity_info_ids.values())))
        ai.attempt, ai.last_failure_reason = 2, "boom"
        items = tuple((i.event_id, i.version) for i in ms.version_histories.current().items)
        pair.pub.publish_sync_activity(ms, ai, items)
        pair.replicate()
        got = pair.standby.execution.get_workflow(*key).pending_activity_info_ids[ai.schedule_id]
        stale = pair.R.SyncActivityTask(
            domain_id=key[0], workflow_id=key[1], run_id=key[2], version=ai.version,
            schedule_id=ai.schedule_id, scheduled_time=0, started_id=-1, started_time=0,
            last_heartbeat_time=0, attempt=1, last_failure_reason="old",
            version_history_items=items)
        return (got.attempt, got.last_failure_reason,
                pair.proc.replicator.sync_activity(stale), pair.processor_counts())

    attempt, reason, stale_applied, _ = both(run)
    assert (attempt, reason, stale_applied) == (2, "boom", False)


def test_replication_counters_preregistered_with_the_jax_names():
    from cadence_tpu.utils import metrics as jm
    from cadence_tpu_torch.utils import metrics as tm

    reg = tm.MetricsRegistry()
    tm.preregister_replication(reg)
    got = reg.snapshot()[tm.SCOPE_REPLICATION]
    assert tm.SCOPE_REPLICATION == jm.SCOPE_REPLICATION
    want = {getattr(jm, n): 0 for n in dir(jm) if n.startswith("M_REPL_")}
    want[jm.M_REPL_DLQ_DEPTH] = 0.0
    assert got == want


def test_device_apply_with_no_device_named_means_the_card(monkeypatch):
    """No fallback: a standby engine with no device named applies on the
    card, and without one the drain raises instead of carrying on on the
    CPU."""
    import torch

    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine

    pair = Pair("cadence_tpu_torch", tpu=False)
    pair.proc.device.tpu = TPUReplayEngine(pair.standby)
    for h in open_histories("cadence_tpu_torch", n=1):
        pair.commit(h, h)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        pair.replicate()
