"""The port's mesh-aware serving paths (cadence_tpu_torch/engine/executor.py
replay_corpus_mesh and stream_wirec_mesh) on meshes of 1, 2 and 4 CPU
slices, beside the JAX package's on the conftest's 8-device CPU mesh:
the serving-path cases of tests/test_mesh_executor.py, with rows, errors,
branches and CRCs compared exactly, the chunk counts, and the per-device
metric series."""
import jax
import numpy as np
import pytest
import torch

from cadence_tpu.engine import executor as je
from cadence_tpu.gen.corpus import generate_corpus
from cadence_tpu.ops.encode import encode_corpus
from cadence_tpu.ops.replay import replay_wirec_to_crc
from cadence_tpu.ops.wirec import pack_wirec
from cadence_tpu.parallel.mesh import make_mesh
from cadence_tpu.utils import metrics as jmetrics
from cadence_tpu_torch.engine import executor as te
from cadence_tpu_torch.ops import replay as tr
from cadence_tpu_torch.parallel.mesh import Mesh
from cadence_tpu_torch.utils import metrics as m

MESHES = (1, 2, 4)


def _events(suite="basic", n=24, seed=3, target=24):
    return encode_corpus(generate_corpus(suite, num_workflows=n, seed=seed, target_events=target))


def _meshes(n):
    return Mesh(["cpu"] * n), make_mesh(jax.devices()[:n])


@pytest.mark.parametrize("suite", ["basic", "ndc"])
@pytest.mark.parametrize("n", MESHES)
def test_replay_corpus_mesh_equals_jax(suite, n):
    ev = _events(suite)
    port, ref = _meshes(n)
    rows, errors, branch, report = te.replay_corpus_mesh(ev, port, chunk_workflows=8,
                                                         registry=m.MetricsRegistry())
    want = je.replay_corpus_mesh(ev, ref, chunk_workflows=8)
    assert report.chunks == want[3].chunks == 3  # genuinely chunked
    for got, w in zip((rows, errors, branch), want[:3]):
        assert got.dtype == w.dtype and np.array_equal(got, w)
    # and the unsharded one-shot replay's rows
    one_rows, one_errors = tr.replay_to_payload(ev, device="cpu")
    assert np.array_equal(rows, one_rows.numpy()) and np.array_equal(errors, one_errors.numpy())


@pytest.mark.parametrize("n", MESHES)
def test_stream_wirec_mesh_equals_jax(n):
    corpus = pack_wirec(_events(n=24))
    port, ref = _meshes(n)
    crcs, errors, report = te.stream_wirec_mesh(corpus, port, n_chunks=2,
                                                registry=m.MetricsRegistry())
    want_crc, want_err, want_report = je.stream_wirec_mesh(corpus, ref, n_chunks=2)
    assert report.chunks == want_report.chunks == 2
    assert crcs.dtype == np.uint32 and np.array_equal(crcs, want_crc)
    assert np.array_equal(errors, want_err)
    crc_ref, _ = replay_wirec_to_crc(corpus.slab, corpus.bases, corpus.n_events, corpus.profile)
    assert np.array_equal(crcs, np.asarray(crc_ref).astype(np.uint32))


def test_per_device_series_equal_jax():
    """tpu.executor's device-labelled series (chunks, real rows per slice,
    the busy gauge) carry the JAX package's values after the same run, and
    the busy gauges settle to 0."""
    ev = _events("timer_retry", n=20, seed=5)
    port, ref = _meshes(4)
    reg = m.MetricsRegistry()
    te.replay_corpus_mesh(ev, port, chunk_workflows=8, registry=reg)
    je.replay_corpus_mesh(ev, ref, chunk_workflows=8)
    jreg = jmetrics.DEFAULT_REGISTRY
    for name in (m.M_EXEC_CHUNKS, m.M_EXEC_ROWS):
        for d in range(4):
            series = m.device_metric(name, d)
            assert series == jmetrics.device_metric(name, d)
            assert reg.counter(m.SCOPE_TPU_EXECUTOR, series) == \
                jreg.counter(jmetrics.SCOPE_TPU_EXECUTOR, series) > 0
    assert sum(reg.counter(m.SCOPE_TPU_EXECUTOR, m.device_metric(m.M_EXEC_ROWS, d))
               for d in range(4)) == 20
    for series in [m.M_EXEC_DEVICE_BUSY] + [m.device_metric(m.M_EXEC_DEVICE_BUSY, d)
                                            for d in range(4)]:
        assert reg.gauge_value(m.SCOPE_TPU_EXECUTOR, series, -1.0) == 0.0


def test_mesh_of_1_keeps_no_skew_counter():
    reg = m.MetricsRegistry()
    te.replay_corpus_mesh(_events(n=10), Mesh(["cpu"]), chunk_workflows=4, registry=reg)
    assert reg.counter(m.SCOPE_TPU_EXECUTOR, m.device_metric(m.M_EXEC_CHUNKS, 0)) == 3
    assert reg.counter(m.SCOPE_TPU_EXECUTOR, m.device_metric(m.M_EXEC_ROWS, 0)) == 0


def test_stream_wirec_mesh_keeps_shards_whole():
    corpus = pack_wirec(_events(n=24))
    with pytest.raises(ValueError, match="whole"):
        te.stream_wirec_mesh(corpus, Mesh(["cpu"] * 4), n_chunks=4)  # 6 rows a chunk
    with pytest.raises(ValueError, match="whole"):
        te.stream_wirec_mesh(corpus, Mesh(["cpu"]), n_chunks=5)


def test_empty_corpus():
    rows, errors, branch, report = te.replay_corpus_mesh(np.zeros((0, 16, 18), np.int64),
                                                         Mesh(["cpu"]))
    assert rows.shape[0] == errors.shape[0] == branch.shape[0] == report.chunks == 0


def test_no_mesh_named_means_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        te.replay_corpus_mesh(_events(n=4))
