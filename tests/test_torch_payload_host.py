"""Kernel B (csrc/payload.cu) with its fit and counts epilogues, compiled as
host C++ (tests/torch_parity.py host_kernel): every block of the launch's
grid run through the kernel's own schedule (payload_block), each phase's
256 threads in turn, in its barrier order, on CPU tensors. Held, exactly,
to the JAX package: rows and overflow to ops/payload.py
payload_rows_narrow, the fit flag to ops/state.py narrow_ok, the counts
to parallel/mesh.py's per-shard stats expression. The card's compile and
launch are held by chip_smoke.py and tests/test_torch_payload_card.py."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import DEFAULT_LAYOUT
from cadence_tpu.gen.corpus import SUITES, generate_corpus
from cadence_tpu.ops import encode as j_encode
from cadence_tpu.ops.payload import payload_rows_narrow as j_narrow
from cadence_tpu.ops.replay import replay_events as j_replay_events
from cadence_tpu.ops.replay import replay_from_state as j_from_state
from cadence_tpu.ops.state import init_state as j_init_state
from cadence_tpu.ops.state import narrow_ok as j_narrow_ok
from cadence_tpu.ops.state import widen_layout
from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT as T_LAYOUT
from cadence_tpu_torch.gen.lanes import trap_corpus
from cadence_tpu_torch.ops import _build
from cadence_tpu_torch.ops.convert import state_from_numpy
from cadence_tpu_torch.ops.state import layout_of, leaves
from cadence_tpu_torch.ops.state import widen_layout as t_widen
from tests.torch_parity import jax_state_from_numpy, jax_state_to_numpy, pad_events

#: workflows a launch: one, a partial block, a block and one, two blocks,
#: and many blocks
WIDTHS = (1, 8, 33, 64, 4096)

HARNESS = r"""
using namespace cadence;

// A step of payload_block on the host: each thread in turn.
struct HostStep {
  template <class F>
  void operator()(F fn) const {
    for (int tid = 0; tid < PAYLOAD_THREADS; ++tid) fn(tid);
  }
};

// Kernel B's launch on the host: every block of its grid, in `order` (a
// permutation of the blocks, or null for 0, 1, ...), each finding its
// shared memory full of garbage. Returns the grid's blocks, or -1 when the
// capacities fit no block.
extern "C" long long host_payload(const void* ptr_table, void* rows, void* overflow, void* fit,
                                  void* counts, void* scratch, int64_t W, const int* caps, int b,
                                  int kv, const int* out_caps, int out_kv, int width, int out_b,
                                  const int64_t* order) {
  const PayloadArgs a = payload_args(caps, b, kv, out_caps, out_b, out_kv, width);
  if (a.nw == 0) return -1;
  const PayloadIO io{state_ptrs(ptr_table), static_cast<int64_t*>(rows),
                     static_cast<uint8_t*>(overflow), static_cast<uint8_t*>(fit),
                     static_cast<int64_t*>(counts), static_cast<unsigned long long*>(scratch), W};
  const int64_t blocks = (W + a.nw - 1) / a.nw;
  std::vector<int64_t> smem((payload_smem(a, a.nw) + 7) / 8);
  for (int64_t i = 0; i < blocks; ++i) {
    const int64_t block = order ? order[i] : i;
    blockIdx.x = static_cast<unsigned>(block);
    std::fill(smem.begin(), smem.end(), int64_t(0x5A5A5A5A5A5A5A5A));
    payload_block(io, a, smem.data(), block, blocks, HostStep{});
  }
  return blocks;
}
"""


@pytest.fixture(scope="module")
def host_b(tmp_path_factory):
    from tests.torch_parity import host_kernel

    lib = host_kernel(tmp_path_factory.mktemp("payload"), "payload.cu",
                      "// The kernel and its launcher", HARNESS,
                      close="}  // namespace\n}  // namespace cadence\n")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_payload.restype = ctypes.c_longlong
    lib.host_payload.argtypes = [P, P, P, P, P, P, ctypes.c_int64, P, I, I, P, I, I, I, P]
    return lib


def _host(lib, s, out, fit=True, counts=True, scratch=None, order=None):
    """Kernel B on the host: (rows, overflow, fit or None, counts or None,
    the grid's blocks)."""
    W = s.state.shape[0]
    lay = layout_of(s)
    table = (ctypes.c_uint64 * len(_build.STATE_FIELDS))(*[t.data_ptr() for _, t in leaves(s)])
    rows = torch.full((W, out.width), -7, dtype=torch.int64)
    ovf = torch.full((W,), True)
    fit_t = torch.full((W,), False) if fit else None
    counts_t = torch.full((2,), -7, dtype=torch.int64) if counts else None
    if counts and scratch is None:
        scratch = torch.zeros(2, dtype=torch.int64)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    blocks = lib.host_payload(
        table, rows.data_ptr(), ovf.data_ptr(), ptr(fit_t), ptr(counts_t), ptr(scratch), W,
        _build.caps(lay), lay.max_branches, lay.max_version_history_items, _build.caps(out),
        out.max_version_history_items, out.width, out.max_branches,
        None if order is None else order.ctypes.data)
    assert blocks > 0
    return rows, ovf, fit_t, counts_t, blocks


def _trap_states(factor):
    """trap_corpus's 36 carried states at x`factor`, replayed by the JAX
    package at that layout."""
    lay = widen_layout(DEFAULT_LAYOUT, factor)
    st, ln = trap_corpus(36, 24, 950 + factor, t_widen(T_LAYOUT, factor))
    return j_from_state(ln, jax_state_from_numpy(st, lay)), lay


def _suite_states():
    """The five suites, 12 workflows each, replayed by the JAX package at
    rung 1 (the ladder's first widening)."""
    lay = widen_layout(DEFAULT_LAYOUT, 2)
    ev = np.concatenate([pad_events(j_encode.encode_corpus(
        generate_corpus(kind, 12, seed=31, target_events=100))) for kind in SUITES])
    return j_replay_events(ev, lay), lay


CASES = {"traps x2": lambda: _trap_states(2), "traps x4": lambda: _trap_states(4),
         "suites at rung 1": _suite_states}
_made = {}


def _case(name):
    """(numpy state, its JAX layout, the JAX references on its rows): rows,
    overflow and fit at the base layout; error and close status."""
    if name not in _made:
        js, lay = CASES[name]()
        rows, ovf = (np.asarray(x) for x in j_narrow(js, DEFAULT_LAYOUT))
        _made[name] = (jax_state_to_numpy(js), lay, rows, ovf,
                       np.asarray(j_narrow_ok(js, DEFAULT_LAYOUT)), np.asarray(js.error),
                       np.asarray(js.close_status))
    return _made[name]


def _stats(error, close_status):
    """parallel/mesh.py's per-shard stats expression."""
    return np.asarray(jnp.stack([(jnp.asarray(error) != 0).sum().astype(jnp.int64),
                                 (jnp.asarray(close_status) != 0).sum().astype(jnp.int64)]))


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("case", list(CASES))
def test_block_schedule_equals_jax(host_b, case, W):
    """Every block of a W-workflow launch on the case's rows (repeated to
    W), both epilogues on: rows, overflow, fit and counts equal the JAX
    package's; the case holds rows that fit and rows that do not."""
    st, _lay, rows, ovf, fit, error, close = _case(case)
    pick = np.arange(W) % len(rows)
    s = state_from_numpy({k: np.ascontiguousarray(v[pick]) for k, v in st.items()},
                         device="cpu")
    got_rows, got_ovf, got_fit, got_counts, _ = _host(host_b, s, T_LAYOUT)
    assert np.array_equal(got_rows.numpy(), rows[pick])
    assert np.array_equal(got_ovf.numpy(), ovf[pick])
    assert np.array_equal(got_fit.numpy(), fit[pick])
    assert np.array_equal(got_counts.numpy(), _stats(error[pick], close[pick]))
    if W == 4096:
        assert fit.any() and (case == "suites at rung 1" or not fit.all())


@pytest.mark.parametrize("case", list(CASES))
def test_epilogues_off_leave_rows_and_overflow_alone(host_b, case):
    """Epilogues off (null outputs): the same rows and overflow flags."""
    st, lay, rows, ovf, *_ = _case(case)
    s = state_from_numpy(st, device="cpu")
    got_rows, got_ovf, got_fit, got_counts, _ = _host(host_b, s, T_LAYOUT, fit=False,
                                                      counts=False)
    assert got_fit is None and got_counts is None
    assert np.array_equal(got_rows.numpy(), rows) and np.array_equal(got_ovf.numpy(), ovf)


def test_fit_is_not_overflow(host_b):
    """A row whose timers hold one entry, in the first slot past the base
    capacity, does not overflow (one entry fits 16) and does not fit (a
    slot position past the cap): JAX's overflow False, narrow_ok False.
    Beside it, each edge of the branch rule: an item on the first branch
    past the base's, the current branch there, a branch at Kv items (fits)
    and one past Kv (overflows nothing unless current, does not fit)."""
    lay = widen_layout(DEFAULT_LAYOUT, 2)
    st = {k: np.array(v) for k, v in jax_state_to_numpy(j_init_state(7, lay)).items()}
    cap, B, Kv = (DEFAULT_LAYOUT.max_timers, DEFAULT_LAYOUT.max_branches,
                  DEFAULT_LAYOUT.max_version_history_items)
    st["timers.occ"][1, cap] = True
    st["timers.started_id"][1, cap] = 5
    st["signals.occ"][2, 0] = True  # a row that fits, for contrast
    st["vh_count"][3, B] = 1
    st["current_branch"][4] = B
    st["vh_count"][5, 1] = Kv
    st["vh_count"][6, 1] = Kv + 1
    js = jax_state_from_numpy(st, lay)
    rows, ovf = (np.asarray(x) for x in j_narrow(js, DEFAULT_LAYOUT))
    fit = np.asarray(j_narrow_ok(js, DEFAULT_LAYOUT))
    assert not ovf[1] and not fit[1] and fit[2]
    assert fit.tolist() == [True, False, True, False, False, True, False]
    assert not ovf[[1, 3, 5, 6]].any()
    got_rows, got_ovf, got_fit, _, _ = _host(host_b, state_from_numpy(st, device="cpu"),
                                             T_LAYOUT)
    assert np.array_equal(got_rows.numpy(), rows)
    assert np.array_equal(got_ovf.numpy(), ovf) and np.array_equal(got_fit.numpy(), fit)


@pytest.mark.parametrize("order", ["in order", "reversed", "shuffled"])
def test_counts_ticket_leaves_nothing_behind(host_b, order):
    """Two launches back to back on one scratch, their blocks in any order
    (the last ticket taken by any block): each writes the stats expression's
    counts and leaves the running total and the ticket at 0."""
    st, _lay, _rows, _ovf, _fit, error, _close = _case("traps x4")
    pick = np.arange(4096) % len(error)
    tiled = {k: np.ascontiguousarray(v[pick]) for k, v in st.items()}
    tiled["close_status"][::3] = 1  # the traps close no workflow
    s = state_from_numpy(tiled, device="cpu")
    want = _stats(error[pick], tiled["close_status"])
    assert want[0] and want[1]
    scratch = torch.zeros(2, dtype=torch.int64)
    blocks = _host(host_b, s, T_LAYOUT, scratch=scratch)[4]
    rng = np.random.default_rng(7)
    perm = {"in order": np.arange(blocks), "reversed": np.arange(blocks)[::-1].copy(),
            "shuffled": rng.permutation(blocks)}[order].astype(np.int64)
    assert scratch.tolist() == [0, 0]
    for _ in range(2):
        counts = _host(host_b, s, T_LAYOUT, fit=False, scratch=scratch, order=perm)[3]
        assert np.array_equal(counts.numpy(), want)
        assert scratch.tolist() == [0, 0]
