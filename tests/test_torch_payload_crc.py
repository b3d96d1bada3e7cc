"""Plain payload and CRC of cadence_tpu_torch against the JAX package:
`payload_rows_narrow` at the base layout and projected from a 2x-widened
state, and `crc32_rows` against the JAX kernel and zlib. Exact."""
import zlib

import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import DEFAULT_LAYOUT, PAD
from cadence_tpu.gen.corpus import generate_corpus
from cadence_tpu.ops import encode as j_encode
from cadence_tpu.ops.crc import crc32_rows as j_crc32_rows
from cadence_tpu.ops.payload import payload_rows_narrow as j_narrow
from cadence_tpu.ops.replay import replay_events as j_replay_events
from cadence_tpu.ops.state import widen_layout
from cadence_tpu_torch.gen.lanes import random_lanes
from cadence_tpu_torch.ops.convert import state_from_numpy
from cadence_tpu_torch.ops.crc import crc32_rows
from cadence_tpu_torch.ops.payload import payload_rows, payload_rows_narrow
from cadence_tpu_torch.ops.state import widen_state
from tests.torch_parity import jax_state_to_numpy, pad_events


def _corpus(kind):
    if kind == "lanes":
        return pad_events(random_lanes(64, 128, 21))
    return pad_events(j_encode.encode_corpus(
        generate_corpus(kind, 64, seed=13, target_events=100)))


@pytest.mark.parametrize("kind", ["basic", "overflow", "lanes"])
@pytest.mark.parametrize("factor", [1, 2])
def test_payload_rows_narrow(kind, factor):
    """The same JAX final state, carried across, gives the JAX rows and
    overflow flags; at factor 2 the state is replayed at the widened
    layout and projected down to the base one."""
    layout = widen_layout(DEFAULT_LAYOUT, factor)
    js = j_replay_events(_corpus(kind), layout)
    want_rows, want_ovf = (np.asarray(x) for x in j_narrow(js, DEFAULT_LAYOUT))
    s = state_from_numpy(jax_state_to_numpy(js), device="cpu")
    rows, ovf = payload_rows_narrow(s, DEFAULT_LAYOUT)
    assert rows.dtype == torch.int64 and rows.shape == (64, DEFAULT_LAYOUT.width)
    assert np.array_equal(rows.numpy(), want_rows)
    assert np.array_equal(ovf.numpy(), want_ovf)
    if factor == 1:
        assert np.array_equal(payload_rows(s).numpy(), want_rows)
    if kind == "lanes" and factor == 2:
        assert want_ovf.any() and not want_ovf.all()


def test_widen_state_projects_to_the_same_rows():
    js = j_replay_events(_corpus("lanes"))
    s = state_from_numpy(jax_state_to_numpy(js), device="cpu")
    wide = widen_state(s, widen_layout(DEFAULT_LAYOUT, 2))
    rows, ovf = payload_rows_narrow(wide, DEFAULT_LAYOUT)
    assert np.array_equal(rows.numpy(), payload_rows(s).numpy())
    assert not ovf.numpy().any()


def _random_rows(seed, W=64, width=DEFAULT_LAYOUT.width):
    rng = np.random.default_rng(seed)
    rows = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, size=(W, width),
                        dtype=np.int64, endpoint=True)
    rows[rng.random((W, width)) < 0.2] = PAD
    rows[rng.random((W, width)) < 0.2] = -1
    rows[rng.random((W, width)) < 0.1] = 0
    rows[0] = np.iinfo(np.int64).min
    return rows


@pytest.mark.parametrize("seed", range(3))
def test_crc32_rows(seed):
    rows = _random_rows(seed)
    got = crc32_rows(torch.from_numpy(rows))
    assert got.dtype == torch.int64
    want = np.asarray(j_crc32_rows(rows)).astype(np.int64)
    assert np.array_equal(got.numpy(), want)
    zl = np.array([zlib.crc32(r.astype("<i8").tobytes()) for r in rows], dtype=np.int64)
    assert np.array_equal(got.numpy(), zl)


@pytest.mark.parametrize("suite", ["basic", "echo_signal", "timer_retry", "concurrent_child",
                                   "ndc", "overflow"])
def test_replay_to_crc(suite):
    """ops/crc.replay_to_crc (kernels A, B and C in turn) against the JAX
    package's, on tests/test_device_crc.py's shapes: the same CRCs and
    errors, overflowing rows included."""
    from cadence_tpu.ops.crc import replay_to_crc as j_replay_to_crc
    from cadence_tpu_torch.ops.crc import replay_to_crc

    ev = pad_events(j_encode.encode_corpus(generate_corpus(suite, 24, seed=3, target_events=60)),
                    num_workflows=24)
    crc_j, err_j = (np.asarray(x) for x in j_replay_to_crc(ev, DEFAULT_LAYOUT))
    crc, err = replay_to_crc(ev, DEFAULT_LAYOUT, device="cpu")
    assert np.array_equal(crc.numpy().astype(np.uint32), crc_j)
    assert np.array_equal(err.numpy(), err_j)
    if suite == "overflow":
        assert (err_j != 0).any()


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("replayed", [False, True])
def test_payload_rows_narrow_on_trap_states(factor, replayed):
    """Kernel B's plain version on trap_corpus's states (full tables,
    duplicate keys, a run reset, forks, sticky errors, a history at Kv),
    carried or replayed by the JAX package, projected to the base layout,
    equals the JAX package's rows and flags; from rung 1 some rows' final
    counts exceed the base capacities and are flagged."""
    from cadence_tpu.ops.replay import replay_from_state as j_from_state
    from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as T_LAYOUT
    from cadence_tpu_torch.gen.lanes import trap_corpus
    from cadence_tpu_torch.ops.state import widen_layout as t_widen
    from tests.torch_parity import jax_state_from_numpy

    st, ln = trap_corpus(36, 24, 950 + factor, t_widen(T_LAYOUT, factor))
    js = jax_state_from_numpy(st, widen_layout(DEFAULT_LAYOUT, factor))
    if replayed:
        js = j_from_state(ln, js)
    want_rows, want_ovf = (np.asarray(x) for x in j_narrow(js, DEFAULT_LAYOUT))
    rows, ovf = payload_rows_narrow(state_from_numpy(jax_state_to_numpy(js), device="cpu"),
                                    DEFAULT_LAYOUT)
    assert np.array_equal(rows.numpy(), want_rows)
    assert np.array_equal(ovf.numpy(), want_ovf)
    if factor == 2:
        assert want_ovf.any() and not want_ovf.all()
