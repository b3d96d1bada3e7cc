"""The port's copies of the JAX-free host modules the bulk verify path
reads (engine/persistence.py Stores, engine/cache.py, engine/crashpoints.py,
engine/membership.py) and the host half of engine/snapshot.py, beside the
JAX package's: the same writes give the same answers, pack_state_row gives
the JAX package's bytes for the same state and unpack_state_row rebuilds
it. The device visibility twin is held to the JAX package's in
tests/test_torch_visibility_device.py."""
import zlib

import jax
import numpy as np
import pytest

from cadence_tpu.core.checksum import DEFAULT_LAYOUT
from cadence_tpu.engine import crashpoints as jcp
from cadence_tpu.engine import membership as jmem
from cadence_tpu.engine import snapshot as jsnap
from cadence_tpu.engine.cache import PackCache as JPackCache
from cadence_tpu.engine.persistence import VisibilityRecord as JRecord
from cadence_tpu.ops.replay import replay_events as jreplay
from cadence_tpu.ops.state import widen_layout
from cadence_tpu_torch.engine import crashpoints as tcp
from cadence_tpu_torch.engine import membership as tmem
from cadence_tpu_torch.engine import snapshot as tsnap
from cadence_tpu_torch.engine.cache import PackCache, content_address
from cadence_tpu_torch.engine.persistence import EntityNotExistsError, VisibilityRecord
from cadence_tpu_torch.ops.convert import state_from_numpy
from cadence_tpu_torch.ops.replay import replay_events
from cadence_tpu_torch.ops.state import map_state
from cadence_tpu_torch.utils import metrics as m
from tests.torch_parity import (PACKAGES, assert_states_equal, jax_state_to_numpy, package,
                                pad_events, stores_with)


def _hists(pkg):
    gen = package(pkg, "gen.corpus")
    return [h for s in ("basic", "ndc", "timer_retry")
            for h in gen.generate_corpus(s, 4, seed=12, target_events=30)]


@pytest.fixture()
def both():
    """{package: (stores, keys)} over the same histories, the first key
    forked at its third event onto a higher-version branch made current."""
    out = {}
    for pkg in PACKAGES:
        stores, keys = stores_with(_hists(pkg), pkg)
        ev = package(pkg, "core.events")
        et = package(pkg, "core.enums").EventType
        b = stores.history.fork_branch(*keys[0], 0, 3)
        stores.history.append_batch(*keys[0], [ev.HistoryEvent(
            id=4, event_type=et.WorkflowExecutionSignaled, version=9, timestamp=5)], branch=b)
        stores.history.set_current_branch(*keys[0], b)
        out[pkg] = (stores, keys)
    return out


def _view(pkg, stores, keys):
    """Everything the read side answers for these keys, as plain values."""
    codec = package(pkg, "core.codec")
    checksum = package(pkg, "core.checksum")
    hs, ex = stores.history, stores.execution
    out = {"runs": hs.list_runs(), "executions": ex.list_executions()}
    for key in keys:
        out[key] = (
            hs.branch_count(*key), hs.get_current_branch(*key), hs.batch_count(*key),
            hs.serialized_size(*key),
            [(e.id, e.version, int(e.event_type)) for e in hs.read_events(*key)],
            [(e.id, e.version) for e in hs.read_events(*key, branch=0)],
            codec.serialize_history(hs.as_history_batches(*key)),
            ex.get_current_run_id(*key[:2]), ex.get_version(*key),
            checksum.payload_row(ex.get_workflow(*key)).tolist(),
        )
    return out


def test_stores_answer_as_jax(both):
    views = {pkg: _view(pkg, *both[pkg]) for pkg in PACKAGES}
    assert views["cadence_tpu_torch"] == views["cadence_tpu"]
    assert views["cadence_tpu"][both["cadence_tpu"][1][0]][0] == 2


def test_overwrite_upsert_and_missing_keys_as_jax(both):
    for pkg in PACKAGES:
        stores, keys = both[pkg]
        ev = package(pkg, "core.events")
        et = package(pkg, "core.enums").EventType
        key = keys[2]
        events = stores.history.read_events(*key)
        # re-appending at an id the branch holds overwrites the tail
        stores.history.append_batch(*key, [ev.HistoryEvent(
            id=events[-2].id, event_type=et.WorkflowExecutionSignaled,
            version=events[-2].version, timestamp=events[-2].timestamp)])
        ms = stores.execution.get_workflow(*key)
        ms.execution_info.signal_count += 1
        stores.execution.upsert_workflow(ms)
    views = {pkg: _view(pkg, *both[pkg]) for pkg in PACKAGES}
    assert views["cadence_tpu_torch"] == views["cadence_tpu"]
    stores, _ = both["cadence_tpu_torch"]
    with pytest.raises(EntityNotExistsError):
        stores.history.read_batches("d", "missing", "r")
    with pytest.raises(EntityNotExistsError):
        stores.execution.get_workflow("d", "missing", "r")


@pytest.mark.parametrize("factor", [1, 2])
def test_pack_state_row_bytes_equal_jax(factor):
    from cadence_tpu.gen.corpus import generate_corpus
    from cadence_tpu.ops.encode import encode_corpus

    layout = widen_layout(DEFAULT_LAYOUT, factor) if factor > 1 else DEFAULT_LAYOUT
    ev = np.concatenate([pad_events(encode_corpus(generate_corpus(s, 2, seed=7, target_events=30)),
                                    96) for s in ("basic", "concurrent_child", "overflow")])
    js = jreplay(ev, layout)
    ts = replay_events(ev, layout, device="cpu")
    for w in range(ev.shape[0]):
        jrow = jax.tree_util.tree_map(lambda a: a[w:w + 1], js)
        blob = jsnap.pack_state_row(jrow)
        assert tsnap.pack_state_row(map_state(lambda t: t[w:w + 1], ts)) == blob
        assert tsnap.pack_state_row(state_from_numpy(jax_state_to_numpy(jrow), "cpu")) == blob
        back = tsnap.unpack_state_row(blob, layout)
        assert_states_equal(back, jsnap.unpack_state_row(blob, layout))
        assert tsnap.pack_state_row(back) == blob


def test_unpack_refuses_torn_and_foreign_blobs():
    blob = tsnap.pack_state_row(map_state(lambda t: t[:1],
                                          replay_events(np.zeros((1, 4, 18), np.int64),
                                                        device="cpu")))
    with pytest.raises(tsnap.SnapshotFormatError, match="magic"):
        tsnap.unpack_state_row(b"X" + blob[1:], DEFAULT_LAYOUT)
    with pytest.raises(tsnap.SnapshotFormatError, match="bytes"):
        tsnap.unpack_state_row(blob[:-1], DEFAULT_LAYOUT)
    with pytest.raises(tsnap.SnapshotFormatError, match="bytes"):
        tsnap.unpack_state_row(blob, widen_layout(DEFAULT_LAYOUT, 2))


def _record(pkg, key, batches, layout=DEFAULT_LAYOUT):
    snap = package(pkg, "engine.snapshot")
    addr = package(pkg, "engine.cache").content_address(batches)
    blob = b"CSNP1\n" + bytes(8)
    return snap.SnapshotRecord(
        key=key, batch_count=addr.batch_count, last_batch_crc=addr.last_batch_crc, events=9,
        history_size=100, branch=0, payload=np.zeros(layout.width, np.int64), state_blob=blob,
        blob_crc=zlib.crc32(blob), interner={"a": 1}, layout=snap.layout_signature(layout))


def test_snapshot_store_invalidation_as_jax(both):
    """Records dropped by the history store's mutations: a tail overwrite
    at or before the snapshot point and an NDC branch switch."""
    kept = {}
    for pkg in PACKAGES:
        stores, keys = both[pkg]
        snaps = stores.snapshot
        for key in keys[1:6]:
            snaps.put(_record(pkg, key, stores.history.as_history_batches(*key)))
        ev = package(pkg, "core.events")
        et = package(pkg, "core.enums").EventType
        first = stores.history.read_events(*keys[2])[0]
        stores.history.append_batch(*keys[2], [ev.HistoryEvent(
            id=first.id, event_type=et.WorkflowExecutionStarted, version=first.version,
            timestamp=first.timestamp)])
        b = stores.history.fork_branch(*keys[3], 0, 2)
        stores.history.set_current_branch(*keys[3], b)
        kept[pkg] = (sorted(snaps.keys()), len(snaps), snaps.stats())
    assert kept["cadence_tpu_torch"] == kept["cadence_tpu"]
    assert kept["cadence_tpu"][1] == 3


def test_validate_record_as_jax(both):
    stores, keys = both["cadence_tpu_torch"]
    jstores, jkeys = both["cadence_tpu"]
    reg = m.MetricsRegistry()
    rec = _record("cadence_tpu_torch", keys[1], stores.history.as_history_batches(*keys[1]))
    jrec = _record("cadence_tpu", jkeys[1], jstores.history.as_history_batches(*jkeys[1]))
    assert rec.address == tuple(jrec.address) and rec.nbytes == jrec.nbytes
    assert tsnap.validate_record(rec, DEFAULT_LAYOUT, reg)
    assert not tsnap.validate_record(rec, widen_layout(DEFAULT_LAYOUT, 2), reg)
    rec.blob_crc ^= 1
    assert not tsnap.validate_record(rec, DEFAULT_LAYOUT, reg)
    assert reg.counter(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_IGNORED_STALE) == 1
    assert reg.counter(m.SCOPE_TPU_SNAPSHOT, m.M_SNAP_IGNORED_TORN) == 1
    assert tsnap.layout_signature(DEFAULT_LAYOUT) == jsnap.layout_signature(DEFAULT_LAYOUT)


@pytest.mark.parametrize("knob", [None, "", "0", "off"])
def test_visibility_host_queries_as_jax(monkeypatch, knob):
    if knob is None:
        monkeypatch.delenv("CADENCE_TPU_VISIBILITY", raising=False)
    else:
        monkeypatch.setenv("CADENCE_TPU_VISIBILITY", knob)
    answers = []
    for pkg, rec_cls in zip(PACKAGES, (JRecord, VisibilityRecord)):
        stores = package(pkg, "engine.persistence").Stores()
        for i in range(6):
            stores.visibility.record_started(rec_cls("d", f"w{i}", "r", f"t{i % 2}", 10 + i))
        stores.visibility.record_closed("d", "w1", "r", 30, 1)
        q = "WorkflowType = 't1' and StartTime > 10"
        answers.append((sorted(r.workflow_id for r in stores.visibility.query("d", q)),
                        stores.visibility.count("d"),
                        [r.workflow_id for r in stores.visibility.query_page("d", "", 4)[0]]))
    assert answers[0] == answers[1]
    assert answers[1][0] == ["w1", "w3", "w5"]


def test_crashpoint_spec_as_jax():
    spec = "site=wal.append.after-write,hit=3,mode=kill,type=h,torn=0.25"
    got, want = tcp.parse_spec(spec), jcp.parse_spec(spec)
    assert (got.site, got.hit, got.mode, got.record_type, got.torn_fraction) == \
        (want.site, want.hit, want.mode, want.record_type, want.torn_fraction)
    with pytest.raises(ValueError, match="unknown knob"):
        tcp.parse_spec("site=x,bogus=1")


def test_shard_for_workflow_as_jax():
    ids = [f"wf-{i}" for i in range(300)]
    assert [tmem.shard_id_for_workflow(w, 16) for w in ids] == \
        [jmem.shard_id_for_workflow(w, 16) for w in ids]


def test_pack_cache_as_jax():
    """Cold pack, exact hit, and a suffix pack after an appended batch: the
    same rows as the JAX package's cache, and the same counters."""
    from cadence_tpu.utils import metrics as jm

    hists = {pkg: _hists(pkg) for pkg in PACKAGES}
    reg, jreg = m.MetricsRegistry(), jm.MetricsRegistry()
    caches = {"cadence_tpu": JPackCache(registry=jreg), "cadence_tpu_torch": PackCache(registry=reg)}
    rows = {pkg: [] for pkg in PACKAGES}
    for pkg in PACKAGES:
        cache = caches[pkg]
        for i, h in enumerate(hists[pkg]):
            key = ("d", f"w{i}", "r")
            rows[pkg].append(cache.encode(key, h[:-1]))
            rows[pkg].append(cache.encode(key, h[:-1]))
            rows[pkg].append(cache.encode(key, h))
    for g, w in zip(rows["cadence_tpu_torch"], rows["cadence_tpu"]):
        assert np.array_equal(g, w)
    for name in (m.M_CACHE_HITS, m.M_CACHE_MISSES, m.M_CACHE_SUFFIX_PACKS):
        assert reg.counter(m.SCOPE_PACK_CACHE, name) == jreg.counter(jm.SCOPE_PACK_CACHE, name) \
            == len(hists["cadence_tpu"])
    assert content_address(hists["cadence_tpu_torch"][0]) == \
        tuple(package("cadence_tpu", "engine.cache").content_address(hists["cadence_tpu"][0]))
