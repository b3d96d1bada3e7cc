"""The port's pipelined feeder (cadence_tpu_torch/native/feeder.py) against
the JAX package's native/feeder.py, on the CPU (device="cpu": the plain
replay behind the same executor, ring and packers): the same histories
give the same rows, CRCs, errors, event counts, chunk counts and refits,
through the native and the numpy wirec encoders, on a mesh of two CPU
slices as on one. Shapes are tests/test_feeder.py's; tolerance 0."""
import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import crc32_of_rows
from cadence_tpu.gen.corpus import SUITES, generate_corpus
from cadence_tpu.native import feeder as jf
from cadence_tpu.native import wirec as jnw
from cadence_tpu.ops.encode import history_length
from cadence_tpu_torch.native import feeder as tf
from cadence_tpu_torch.native import wirec as tnw
from cadence_tpu_torch.parallel.mesh import Mesh
from tests.torch_parity import reference_native

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _reference_libraries():
    reference_native()


@pytest.fixture(scope="module")
def mixed():
    """tests/test_feeder.py's corpus: six workflows of every suite."""
    return [h for suite in SUITES for h in generate_corpus(suite, num_workflows=6, seed=5,
                                                            target_events=40)]


@pytest.fixture(scope="module")
def mixed_jax(mixed):
    return jf.feed_corpus(mixed, chunk_workflows=8)


def test_feed_corpus_rows_and_errors_equal(mixed, mixed_jax):
    rows_j, err_j, rep_j = mixed_jax
    rows, errors, report = tf.feed_corpus(mixed, chunk_workflows=8, device=CPU)
    assert np.array_equal(rows, rows_j) and np.array_equal(errors, err_j)
    assert (report.workflows, report.chunks, report.events) == (rep_j.workflows, rep_j.chunks,
                                                                 rep_j.events)
    assert report.chunks == -(-len(mixed) // 8)
    assert report.events_per_sec > 0 and report.pack_events_per_sec >= report.events_per_sec


def test_feed_pads_the_tail_chunk():
    hists = generate_corpus("basic", num_workflows=5, seed=3, target_events=30)
    rows, errors, report = tf.feed_corpus(hists, chunk_workflows=4, device=CPU)
    rows_j, err_j, _ = jf.feed_corpus(hists, chunk_workflows=4)
    assert rows.shape[0] == 5 and errors.shape[0] == 5 and (errors == 0).all()
    assert report.chunks == 2
    assert np.array_equal(rows, rows_j) and np.array_equal(errors, err_j)


def test_feed_counts_the_real_events():
    hists = generate_corpus("basic", num_workflows=4, seed=9, target_events=30)
    _, _, report = tf.feed_corpus(hists, chunk_workflows=4, device=CPU)
    assert report.events == sum(history_length(h) for h in hists)
    assert report.events == jf.feed_corpus(hists, chunk_workflows=4)[2].events


def test_feed_corpus32_crcs_equal():
    hists = generate_corpus("basic", num_workflows=96, seed=13, target_events=60)
    E = max(history_length(h) for h in hists)
    crcs, errors, report = tf.feed_corpus32(hists, chunk_workflows=32, max_events=E, device=CPU)
    crcs_j, err_j, rep_j = jf.feed_corpus32(hists, chunk_workflows=32, max_events=E)
    assert report.chunks == 3 and report.workflows == 96 and (errors == 0).all()
    assert crcs.dtype == np.uint32 and np.array_equal(crcs, crcs_j)
    assert np.array_equal(errors, err_j) and report.events == rep_j.events
    rows, _, _ = tf.feed_corpus(hists, chunk_workflows=32, max_events=E, device=CPU)
    assert np.array_equal(crcs, crc32_of_rows(rows))  # the int64 path's CRCs


@pytest.mark.parametrize("env", ["", "0"], ids=["native", "numpy"])
def test_feed_corpus_wirec_equal(env, monkeypatch):
    hists = generate_corpus("basic", num_workflows=48, seed=21, target_events=40)
    monkeypatch.setenv(tnw.NATIVE_WIREC_ENV, env)
    monkeypatch.setenv(jnw.NATIVE_WIREC_ENV, env)
    crcs, errors, report = tf.feed_corpus_wirec(hists, chunk_workflows=16, device=CPU)
    crcs_j, err_j, rep_j = jf.feed_corpus_wirec(hists, chunk_workflows=16)
    assert report.native_wirec == (env == "") == rep_j.native_wirec
    assert np.array_equal(crcs, crcs_j) and np.array_equal(errors, err_j)
    assert (report.events, report.chunks, report.wire_bytes, report.profile_refits) == (
        rep_j.events, rep_j.chunks, rep_j.wire_bytes, rep_j.profile_refits)
    assert report.chunks == 3 and report.profile_refits == 0 and report.h2d_s >= 0.0
    rows, _, _ = tf.feed_corpus(hists, chunk_workflows=16, device=CPU)
    assert np.array_equal(crcs, crc32_of_rows(rows))


@pytest.mark.parametrize("env", ["", "0"], ids=["native", "numpy"])
def test_heterogeneous_stream_refits_as_the_jax_package(env, monkeypatch):
    """Chunk 1 falls outside chunk 0's pinned profile: both packages refit
    it (counted) on either encoder and land on the same CRCs."""
    hists = generate_corpus("basic", num_workflows=16, seed=3, target_events=30)
    hists += generate_corpus("timer_retry", num_workflows=16, seed=3, target_events=30)
    monkeypatch.setenv(tnw.NATIVE_WIREC_ENV, env)
    monkeypatch.setenv(jnw.NATIVE_WIREC_ENV, env)
    crcs, errors, report = tf.feed_corpus_wirec(hists, chunk_workflows=16, device=CPU)
    crcs_j, err_j, rep_j = jf.feed_corpus_wirec(hists, chunk_workflows=16)
    assert report.profile_refits == rep_j.profile_refits >= 1
    assert np.array_equal(crcs, crcs_j) and np.array_equal(errors, err_j)


def _resident(pkg, hists, keys):
    """A resident pool of package `pkg` holding each history's prefix (all
    but its last batch), and the pack cache that encoded it."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    layout = mod("core.checksum").DEFAULT_LAYOUT
    pack_cache = mod("engine.cache").PackCache(max_size=64)
    kw = {"device": CPU} if pkg == "cadence_tpu_torch" else {}
    cache = mod("engine.resident").ResidentStateCache(
        layout, ladder=mod("engine.ladder").EscalationLadder(layout, **kw), **kw)
    prefix = [pack_cache.encode(k, h[:-1]) for k, h in zip(keys, hists)]
    corpus = mod("ops.encode").assemble_corpus(prefix, max(r.shape[0] for r in prefix))
    replay = mod("ops.replay")
    if pkg == "cadence_tpu_torch":
        s = replay.replay_events(corpus, layout, device=CPU)
        rows = mod("ops.payload").payload_rows(s, layout).numpy()
    else:
        import jax.numpy as jnp

        s = replay.replay_events(jnp.asarray(corpus), layout)
        rows = np.asarray(mod("ops.payload").payload_rows(s, layout))
    address = mod("engine.cache").content_address
    for i, k in enumerate(keys):
        assert cache.admit(k, address(hists[i][:-1]), cache.extract_row(s, i), rows[i],
                           int(s.current_branch[i]))
    return cache, pack_cache


def test_feed_appends_equal_and_counts_only_appended_events():
    from cadence_tpu_torch.gen.corpus import generate_corpus as t_generate
    from tests.torch_parity import reset_port_tiers

    hists = t_generate("basic", num_workflows=16, seed=33, target_events=60)
    hists_j = generate_corpus("basic", num_workflows=16, seed=33, target_events=60)
    keys = [("d", f"wf-{i}", "r") for i in range(len(hists))]
    try:
        cache, pack_cache = _resident("cadence_tpu_torch", hists, keys)
        cache_j, pack_cache_j = _resident("cadence_tpu", hists_j, keys)
        items = list(zip(keys, hists))
        results, report = tf.feed_appends(items, cache, pack_cache)
        results_j, report_j = jf.feed_appends(list(zip(keys, hists_j)), cache_j, pack_cache_j)
        assert all(r.ok for r in results)
        assert report.events == report_j.events == sum(len(h[-1].events) for h in hists)
        assert report.chunks == report_j.chunks >= 1
        for r, rj in zip(results, results_j):
            assert np.array_equal(np.asarray(r.payload), np.asarray(rj.payload))
            assert (r.branch, r.rung) == (rj.branch, rj.rung)
        # the second pass: exact hits from the resident payloads, no device work
        again, report2 = tf.feed_appends(items, cache, pack_cache)
        assert all(r.ok for r in again) and (report2.events, report2.chunks) == (0, 0)
        assert all(np.array_equal(a.payload, r.payload) for a, r in zip(again, results))
    finally:
        reset_port_tiers()


@pytest.mark.parametrize("feed", ["feed_corpus", "feed_corpus32", "feed_corpus_wirec"])
def test_a_mesh_of_two_cpu_slices_equals_one(feed, mixed):
    fn = getattr(tf, feed)
    one = fn(mixed, chunk_workflows=8, device=CPU)
    two = fn(mixed, chunk_workflows=8, mesh=Mesh([CPU] * 2))
    assert np.array_equal(one[0], two[0]) and np.array_equal(one[1], two[1])
    assert two[2].events == one[2].events and two[2].chunks == one[2].chunks


@pytest.mark.parametrize("feed", ["feed_corpus", "feed_corpus32", "feed_corpus_wirec"])
def test_feeds_raise_without_cuda(feed, mixed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tf, feed)(mixed[:4], chunk_workflows=4)
