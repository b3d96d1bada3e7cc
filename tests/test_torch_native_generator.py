"""The port's host corpus generator (cadence_tpu_torch/native/gen_native.py,
generator.cc copied byte for byte) against the JAX package's: the same
(seed, first index, W, E) give the same lanes, and the port's replay of
them the JAX package's rows. generator.cc runs its own sequential splitmix
stream, so its histories are not ops/genkernel.py's; each generator is
held to its own JAX counterpart. Shapes are tests/test_native_generator.py's
(W=48, E=200)."""
import ctypes
import filecmp
import os

import numpy as np
import pytest

from cadence_tpu.native.gen_native import generate_corpus_native as j_generate
from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row
from cadence_tpu_torch.core.enums import EventType, WorkflowState
from cadence_tpu_torch.native import build as nbuild
from cadence_tpu_torch.native.gen_native import generate_corpus_native, generator_available
from cadence_tpu_torch.ops.encode import decode_lanes
from cadence_tpu_torch.ops.replay import replay_to_payload
from cadence_tpu_torch.oracle.state_builder import StateBuilder
from tests.torch_parity import reference_native

W, E = 48, 200
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _reference_libraries():
    reference_native()


@pytest.fixture(scope="module")
def corpus():
    return generate_corpus_native(seed=5, first_index=0, num_workflows=W, max_events=E)


def test_the_source_is_the_reference_s():
    assert filecmp.cmp(os.path.join(ROOT, "cadence_tpu_torch/native/generator.cc"),
                       os.path.join(ROOT, "cadence_tpu/native/generator.cc"), shallow=False)
    assert generator_available()


def test_lanes_same_bytes(corpus):
    lanes, total = corpus
    want, total_j = j_generate(5, 0, W, E)
    assert lanes.dtype == np.int64 and np.array_equal(lanes, want)
    assert total == total_j == int((lanes[:, :, 0] > 0).sum())


def test_seam_at_24(corpus):
    lanes, _ = corpus
    tail, _ = generate_corpus_native(5, 24, W - 24, E)
    assert np.array_equal(tail, lanes[24:])
    assert np.array_equal(tail, j_generate(5, 24, W - 24, E)[0])


def test_distinct_and_reproducible(corpus):
    lanes, total = corpus
    assert total > W * E // 2
    assert len({lanes[i].tobytes() for i in range(W)}) == W
    out = np.empty_like(lanes)
    again, total2 = generate_corpus_native(5, 0, W, E, out=out)
    assert again is out and total2 == total and np.array_equal(again, lanes)


def test_a_wrong_out_buffer_raises():
    with pytest.raises(ValueError, match="out buffer"):
        generate_corpus_native(5, 0, 4, 10, out=np.empty((4, 10, 18), dtype=np.int32))


def test_replay_equals_the_jax_package_s(corpus):
    import jax.numpy as jnp

    from cadence_tpu.ops.replay import replay_to_payload as j_replay

    lanes, _ = corpus
    rows_j, err_j = map(np.asarray, j_replay(jnp.asarray(lanes)))
    rows_t, err_t = replay_to_payload(lanes, device="cpu")
    assert (err_j == 0).all()
    assert np.array_equal(rows_t.numpy(), rows_j) and np.array_equal(err_t.numpy(), err_j)


def test_oracle_valid_and_histories_close(corpus):
    lanes, _ = corpus
    rows, errors = replay_to_payload(lanes, device="cpu")
    rows = rows.numpy()
    for i in range(W):
        real = lanes[i][lanes[i][:, 0] > 0]
        assert real[0][1] == int(EventType.WorkflowExecutionStarted)
        assert real[-1][1] == int(EventType.WorkflowExecutionCompleted)
    for i in range(0, W, 6):
        ms = StateBuilder().replay_history(decode_lanes(lanes[i]))
        expected = payload_row(ms)
        expected[STICKY_ROW_INDEX] = 0
        assert np.array_equal(rows[i], expected), f"workflow {i} diverged"
        assert ms.execution_info.state == WorkflowState.Completed
        assert not ms.pending_activity_info_ids and not ms.pending_timer_info_ids


def test_generator_declares_the_64_bit_abi():
    fn = nbuild.load_generator().cadence_generate_corpus
    i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    assert fn.restype is i64
    assert list(fn.argtypes) == [ctypes.c_uint64, i64, i64, i64, i64, i64p, i64]
    assert os.path.basename(nbuild.generator_library_path()).startswith("libcadence_generator_")
