"""The port's device mesh (cadence_tpu_torch/parallel/mesh.py) on the CPU
beside the JAX package's: the workflow -> shard hash, the mesh-width knob,
and every sharded replay on meshes of 1, 2 and 4 CPU slices against the
JAX package's on make_mesh(jax.devices()[:n]) (the conftest's 8-device
CPU mesh): rows or CRCs, errors and the [2] stats, exactly."""
import jax
import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import DEFAULT_LAYOUT
from cadence_tpu.gen.corpus import generate_corpus
from cadence_tpu.ops.encode import encode_corpus, gather_subcorpus, to_wire32
from cadence_tpu.ops.state import widen_layout
from cadence_tpu.ops.wirec import pack_wirec
from cadence_tpu.parallel import mesh as jm
from cadence_tpu_torch.gen.lanes import random_lanes
from cadence_tpu_torch.ops import replay as tr
from cadence_tpu_torch.ops.stats import stats, stats_plain
from cadence_tpu_torch.parallel import mesh as tm
from tests.torch_parity import pad_events

MESHES = (1, 2, 4)
E = 48


@pytest.fixture(scope="module")
def lanes():
    """16 workflows: four suites (closed and open workflows) beside a
    lane-level random corpus (rows with errors), padded to one shape."""
    parts = [encode_corpus(generate_corpus(s, 3, seed=5, target_events=36))
             for s in ("basic", "echo_signal", "timer_retry", "ndc")]
    parts.append(random_lanes(4, 40, 17))
    return np.concatenate([pad_events(p, E) for p in parts])


@pytest.fixture(scope="module")
def flagged():
    """The overflow suite's capacity-flagged rows as a sub-corpus padded to
    16 workflows (a whole slice on every mesh)."""
    events = encode_corpus(generate_corpus("overflow", 256, seed=20260730, target_events=40))
    errors = tr.replay_events(events, device="cpu").error.numpy()
    idx = np.nonzero(errors)[0]
    assert len(idx) >= 2
    return gather_subcorpus(events, idx, 16, E)


def meshes(n):
    return tm.Mesh(["cpu"] * n), jm.make_mesh(jax.devices()[:n])


def assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.uint32:
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_workflow_shard_equals_jax(n):
    keys = [(f"dom-{i % 7}", f"wf-{i}", f"run-{i * 31}") for i in range(1000)]
    got = [tm.workflow_shard(k, n) for k in keys]
    assert got == [jm.workflow_shard(k, n) for k in keys]
    if n > 1:
        assert len(set(got)) == n


@pytest.mark.parametrize("raw", [None, "", "1", "0", "all", "pod", "POD ", "3", "-2", "x", "8"])
def test_mesh_devices_knob_equals_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(tm.MESH_DEVICES_ENV, raising=False)
    else:
        monkeypatch.setenv(tm.MESH_DEVICES_ENV, raw)
    assert tm.MESH_DEVICES_ENV == jm.MESH_DEVICES_ENV
    assert tm.mesh_devices_requested() == jm.mesh_devices_requested()


def test_serving_mesh_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        tm.serving_mesh()
    with pytest.raises(RuntimeError, match="no CUDA"):
        tm.make_mesh()
    assert tm.serving_mesh(["cpu", "cpu"]) == tm.Mesh(["cpu", "cpu"])


@pytest.mark.parametrize("n", MESHES)
def test_replay_sharded_equals_jax(lanes, n):
    port, ref = meshes(n)
    got = tm.replay_sharded(lanes, port)
    assert_equal(got, jm.replay_sharded(lanes, ref))
    assert 0 < int(got[2][0]) < lanes.shape[0] and int(got[2][1]) > 0


@pytest.mark.parametrize("n", MESHES)
def test_replay_sharded_crc_equals_jax(lanes, n):
    port, ref = meshes(n)
    ev32 = to_wire32(lanes)
    assert_equal(tm.replay_sharded_crc(ev32, port), jm.replay_sharded_crc(ev32, ref))


@pytest.mark.parametrize("n", MESHES)
def test_replay_wirec_sharded_crc_equals_jax(lanes, n):
    port, ref = meshes(n)
    corpus = pack_wirec(lanes)
    assert_equal(tm.replay_wirec_sharded_crc(corpus, port),
                 jm.replay_wirec_sharded_crc(corpus, ref))


@pytest.mark.parametrize("n", MESHES)
def test_replay_sharded_escalated_equals_jax(flagged, n):
    port, ref = meshes(n)
    wide = widen_layout(DEFAULT_LAYOUT, 2)
    got = tm.replay_sharded_escalated(flagged, port, wide)
    assert_equal(got, jm.replay_sharded_escalated(flagged, ref, wide))
    assert int((got[1] == 0).sum()) >= 2


@pytest.mark.parametrize("n", MESHES)
def test_replay_wirec_sharded_escalated_crc_equals_jax(flagged, n):
    port, ref = meshes(n)
    wide = widen_layout(DEFAULT_LAYOUT, 2)
    corpus = pack_wirec(flagged)
    assert_equal(tm.replay_wirec_sharded_escalated_crc(corpus, port, wide),
                 jm.replay_wirec_sharded_escalated_crc(corpus, ref, wide))


def test_stats_plain_equals_jax_stats(lanes):
    """Kernel F's plain version on one replayed state against the [2] the
    JAX package's _replay_with_stats returns for the same lanes."""
    s = tr.replay_events(lanes, device="cpu")
    _, _, want = jm._replay_with_stats(lanes, DEFAULT_LAYOUT)
    got = stats_plain(s.error, s.close_status)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(stats(s.error, s.close_status), got)


def test_shards_must_be_whole(lanes):
    with pytest.raises(ValueError, match="do not split evenly"):
        tm.place_corpus(lanes[:5], tm.Mesh(["cpu", "cpu"]))
    with pytest.raises(ValueError, match="do not split evenly"):
        tm.replay_sharded(lanes[:6], tm.Mesh(["cpu"] * 4))


def test_place_corpus_keeps_workflow_order(lanes):
    parts = tm.place_corpus(lanes, tm.Mesh(["cpu"] * 4))
    assert [p.shape[0] for p in parts] == [4] * 4
    assert np.array_equal(torch.cat(parts).numpy(), lanes)
