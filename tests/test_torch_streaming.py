"""The port's event-axis streaming (cadence_tpu_torch/ops/streaming.py) on
the CPU beside the JAX package's: replay_streamed's rows and errors, and a
StreamingReplayer's carried state (all 66 tensors), for chunks of 1, 7
and 32 events, with ragged tails padded as the JAX package pads them."""
import numpy as np
import pytest
import torch

from cadence_tpu.gen.corpus import generate_corpus
from cadence_tpu.ops import streaming as js
from cadence_tpu.ops.encode import encode_corpus
from cadence_tpu_torch.gen.lanes import random_lanes
from cadence_tpu_torch.ops import replay as tr
from cadence_tpu_torch.ops import streaming as ts
from tests.torch_parity import assert_states_equal, pad_events

E = 45  # no multiple of 7 or 32: both chunkings end in a ragged tail


@pytest.fixture(scope="module")
def events():
    parts = [encode_corpus(generate_corpus(s, 3, seed=8, target_events=36))
             for s in ("basic", "timer_retry", "concurrent_child")]
    parts.append(random_lanes(3, 40, 29))
    return np.concatenate([pad_events(p, E) for p in parts])


def _chunks(events, chunk_events):
    """The chunks replay_streamed feeds, tail padded."""
    out = []
    for start in range(0, events.shape[1], chunk_events):
        chunk = events[:, start:start + chunk_events]
        if chunk.shape[1] < chunk_events:
            chunk = pad_events(chunk, chunk_events)
        out.append(chunk)
    return out


@pytest.mark.parametrize("chunk_events", [1, 7, 32])
def test_replay_streamed_equals_jax(events, chunk_events):
    rows, errors = ts.replay_streamed(events, chunk_events, device="cpu")
    want_rows, want_errors = js.replay_streamed(events, chunk_events)
    assert rows.dtype == want_rows.dtype and np.array_equal(rows, want_rows)
    assert errors.dtype == want_errors.dtype and np.array_equal(errors, want_errors)
    assert (errors != 0).any() and (errors == 0).any()


@pytest.mark.parametrize("chunk_events", [1, 7, 32])
def test_streaming_replayer_state_equals_jax(events, chunk_events):
    port = ts.StreamingReplayer(events.shape[0], device="cpu")
    ref = js.StreamingReplayer(events.shape[0])
    for chunk in _chunks(events, chunk_events):
        port.feed(chunk)
        ref.feed(chunk)
    assert_states_equal(port.state, ref.state)
    # and the one-shot replay's state: chunking never changes a result
    assert_states_equal(tr.replay_events(events, device="cpu"), ref.state)


def test_tail_longer_than_the_history(events):
    """One chunk wider than the whole history: all of it padding beyond E."""
    rows, errors = ts.replay_streamed(events, 64, device="cpu")
    want_rows, want_errors = js.replay_streamed(events, 64)
    assert np.array_equal(rows, want_rows) and np.array_equal(errors, want_errors)


def test_feed_checks_the_workflow_count(events):
    with pytest.raises(ValueError, match="workflows"):
        ts.StreamingReplayer(events.shape[0] + 1, device="cpu").feed(events[:, :8])


def test_no_device_named_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        ts.StreamingReplayer(4)
