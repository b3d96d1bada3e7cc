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
