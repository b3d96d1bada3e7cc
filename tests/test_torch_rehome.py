"""Kernel G's and kernel H's plain versions (cadence_tpu_torch/ops/state.py
rehome_plain, narrow_ok_plain) and the CPU routes of widen_state,
narrow_state and narrow_ok, against the JAX package's widen_state,
narrow_state, narrow_ok and the resident pool's _stack_states and
_slice_row, on states replayed from random lanes and from the overflow
suite, at rungs 0-2, with init rows and a widen-then-narrow round trip.
Every value is an integer or a bool: compared exactly."""
import jax
import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import DEFAULT_LAYOUT
from cadence_tpu.engine import resident as jres
from cadence_tpu.gen.corpus import generate_corpus
from cadence_tpu.ops import replay as jr
from cadence_tpu.ops import state as js
from cadence_tpu.ops.encode import encode_corpus
from cadence_tpu_torch.gen.lanes import random_lanes
from cadence_tpu_torch.ops import rehome as trh
from cadence_tpu_torch.ops import state as ts
from cadence_tpu_torch.ops.convert import state_from_numpy
from tests.torch_parity import assert_states_equal, jax_state_to_numpy, pad_events

W = 12


def _corpus(kind):
    if kind == "lanes":
        return pad_events(random_lanes(W, 64, 41), 64)
    return pad_events(encode_corpus(generate_corpus("overflow", W, seed=5, target_events=70)), 80)


@pytest.fixture(scope="module", params=["lanes", "overflow"])
def replayed(request):
    """{rung: (JAX state, port state)} of one corpus replayed at rungs 0-2."""
    ev = _corpus(request.param)
    out = {}
    for rung in range(3):
        lay = js.widen_layout(DEFAULT_LAYOUT, 2 ** rung)
        jst = jr.replay_events(ev, lay)
        out[rung] = (jst, state_from_numpy(jax_state_to_numpy(jst), device="cpu"))
    return out


def _layout(rung):
    return js.widen_layout(DEFAULT_LAYOUT, 2 ** rung)


@pytest.mark.parametrize("src,dst", [(0, 1), (0, 2), (1, 2), (2, 0), (1, 0), (2, 1), (1, 1)])
def test_widen_and_narrow_equal_jax(replayed, src, dst):
    jst, tst = replayed[src]
    lay = _layout(dst)
    fn_j = js.widen_state if dst >= src else js.narrow_state
    fn_t = ts.widen_state if dst >= src else ts.narrow_state
    assert_states_equal(fn_t(tst, lay), fn_j(jst, lay))
    assert_states_equal(ts.rehome_plain(tst, range(W), lay), fn_j(jst, lay))


@pytest.mark.parametrize("src,dst", [(1, 0), (2, 0), (2, 1), (0, 0), (1, 1)])
def test_narrow_ok_equals_jax(replayed, src, dst):
    jst, tst = replayed[src]
    want = np.asarray(js.narrow_ok(jst, _layout(dst)))
    assert np.array_equal(ts.narrow_ok(tst, _layout(dst)).numpy(), want)
    assert np.array_equal(trh.narrow_ok(tst, _layout(dst)).numpy(), want)


def test_widen_narrow_round_trip(replayed):
    """A base state widened to rung 2 and narrowed back is itself; a rung-1
    state narrowed where narrow_ok holds and widened again keeps its rows."""
    jst, tst = replayed[0]
    round_trip = ts.narrow_state(ts.widen_state(tst, _layout(2)), DEFAULT_LAYOUT)
    assert_states_equal(round_trip, jst)
    jw, tw = replayed[1]
    ok = ts.narrow_ok(tw, DEFAULT_LAYOUT).numpy()
    back = ts.widen_state(ts.narrow_state(tw, DEFAULT_LAYOUT), _layout(1))
    for (name, a), (_, b) in zip(ts.leaves(back), ts.leaves(tw)):
        assert torch.equal(a[ok], b[ok]), name


def test_stack_and_slice_equal_jax(replayed):
    """_slice_row of every third row, _stack_states of those W=1 rows with an
    init block: one rehome_plain gather with -1 rows for the init block."""
    jst, tst = replayed[1]
    picked = [0, 3, 6, 9]
    jrows = [jres._slice_row(jst, i) for i in picked]
    for i, jrow in zip(picked, jrows):
        assert_states_equal(ts.rehome_plain(tst, [i], _layout(1)), jrow)
    want = jres._stack_states(jrows + [js.init_state(4, _layout(1))])
    got = ts.rehome_plain(tst, picked + [-1] * 4, _layout(1))
    assert_states_equal(got, want)
    # the same rows re-homed at rung 2 with init rows between them
    want2 = js.widen_state(jres._stack_states([jrows[0], js.init_state(1, _layout(1)), jrows[2]]),
                           _layout(2))
    assert_states_equal(ts.rehome_plain(tst, [0, -1, 6], _layout(2)), want2)


def test_scatter_into_a_destination(replayed):
    """dst rows are written, every other row of dst is left as it was."""
    _, tst = replayed[0]
    dst = ts.init_state(20, DEFAULT_LAYOUT, "cpu")
    before = ts.rehome_plain(dst, range(20), DEFAULT_LAYOUT)
    out = trh.rehome(tst, [4, -1, 2], DEFAULT_LAYOUT, dst, [17, 3, 8])
    assert out is dst
    for (name, d), (_, b), (_, s) in zip(ts.leaves(dst), ts.leaves(before), ts.leaves(tst)):
        keep = [i for i in range(20) if i not in (17, 3, 8)]
        assert torch.equal(d[keep], b[keep]), name
        assert torch.equal(d[17], s[4]) and torch.equal(d[8], s[2]), name
        assert torch.equal(d[3], b[3]), name  # init row into an init state
    with pytest.raises(ValueError, match="appears twice"):
        trh.rehome(tst, [1, 2], DEFAULT_LAYOUT, dst, [5, 5])


@pytest.mark.parametrize("src_rows,dst_rows", [([W, 0], [0, 1]), ([-2, 0], [0, 1]),
                                               ([0, 1], [0, 20]), ([0, 1], [-1, 1])],
                         ids=["src_past_end", "src_below_init", "dst_past_end", "dst_negative"])
def test_rows_outside_the_states_are_refused(replayed, src_rows, dst_rows):
    """Host row indices outside [-1, source rows) and [0, destination rows)
    raise the same ValueError on the CPU route and before kernel G's
    launch (a meta state stands for the card: nothing is launched)."""
    _, tst = replayed[0]
    lay = ts.layout_of(tst)
    for src in (tst, ts.init_state(W, lay, "meta")):
        dst = ts.init_state(20, lay, src.state.device)
        with pytest.raises(ValueError, match="outside"):
            trh.rehome(src, src_rows, lay, dst, dst_rows) if src is tst else \
                trh.rehome_launch(src, src_rows, lay, dst, dst_rows)


def test_empty_source_gives_init_rows():
    src = ts.init_state(0, DEFAULT_LAYOUT, "cpu")
    got = ts.rehome_plain(src, [-1, -1], _layout(1))
    assert_states_equal(got, js.init_state(2, _layout(1)))


def test_field_table_matches_init_state():
    """The per-field init values and element sizes kernel G gets are the
    init_state values of every field, at every rung."""
    init, sizes = trh._field_table()
    for rung in range(3):
        for k, (name, t) in enumerate(ts.leaves(ts.init_state(1, _layout(rung), "cpu"))):
            assert sizes[k] == t.element_size(), name
            assert (t == init[k]).all(), name


def test_cuda_state_never_takes_the_plain_route(monkeypatch):
    """A state that is not on the CPU goes to the kernel or raises."""
    meta = ts.init_state(2, DEFAULT_LAYOUT, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trh.rehome(meta, [0, 1], DEFAULT_LAYOUT)
    with pytest.raises(ValueError, match="unsupported device"):
        trh.narrow_ok(meta, DEFAULT_LAYOUT)
    assert jax.devices()[0].platform == "cpu"


# --- kernel G's walk: the work table and the (field, row, unit) walk --------

def _random_state(n, rung, seed):
    """A port state and its JAX twin of n rows at rung `rung`, every field
    filled with random values of its dtype (a copy kernel must move any
    bits)."""
    from cadence_tpu_torch.ops.convert import state_to_numpy
    from tests.torch_parity import jax_state_from_numpy

    rng = np.random.default_rng(seed)
    mapping = {}
    for name, arr in state_to_numpy(ts.init_state(n, _layout(rung), "cpu")).items():
        if arr.dtype == np.bool_:
            mapping[name] = rng.random(arr.shape) < 0.5
        else:
            info = np.iinfo(arr.dtype)
            mapping[name] = rng.integers(info.min, info.max, arr.shape, dtype=arr.dtype,
                                         endpoint=True)
    return state_from_numpy(mapping, device="cpu"), jax_state_from_numpy(mapping, _layout(rung))


def _jax_gather(jst, rows):
    return jax.tree_util.tree_map(lambda a: a[np.asarray(rows)], jst)


@pytest.mark.parametrize("src,dst", [(0, 0), (0, 1), (0, 2), (1, 2), (2, 0), (1, 0), (2, 1)])
def test_walk_equals_jax_widen_and_narrow(replayed, src, dst):
    """x1, x2 and x4 in both directions: the walk equals rehome_plain and the
    JAX package's widen_state / narrow_state."""
    jst, tst = replayed[src]
    lay = _layout(dst)
    fn_j = js.widen_state if dst >= src else js.narrow_state
    got = trh.rehome_walk_plain(tst, range(W), lay)
    assert_states_equal(got, fn_j(jst, lay))
    assert_states_equal(ts.rehome_plain(tst, range(W), lay), fn_j(jst, lay))


def test_walk_stack_and_slice_equal_jax(replayed):
    """Init rows between gathered rows, as the pool's _stack_states of
    _slice_row rows and init blocks gives them, at x2 and re-homed at x4."""
    jst, tst = replayed[1]
    picked = [0, 3, 6, 9]
    jrows = [jres._slice_row(jst, i) for i in picked]
    want = jres._stack_states(jrows + [js.init_state(3, _layout(1))])
    assert_states_equal(trh.rehome_walk_plain(tst, picked + [-1] * 3, _layout(1)), want)
    want4 = js.widen_state(jres._stack_states([jrows[1], js.init_state(1, _layout(1)),
                                               jrows[3]]), _layout(2))
    assert_states_equal(trh.rehome_walk_plain(tst, [3, -1, 9], _layout(2)), want4)


@pytest.mark.parametrize("out_rung", [0, 1])
def test_walk_scatter_into_a_larger_slab(replayed, out_rung):
    """Rows (and an init row) scattered into a 40-row slab: at the same
    layout whole rows move, widened an element a unit; every other slab row
    is left as it was, as rehome_plain leaves it."""
    _, tst = replayed[0]
    lay = _layout(out_rung)
    slab, _ = _random_state(40, out_rung, 7)
    want = ts.rehome_plain(tst, [4, -1, 2, 11], lay, ts.map_state(torch.clone, slab),
                           [39, 0, 17, 5])
    got = trh.rehome_walk_plain(tst, [4, -1, 2, 11], lay, ts.map_state(torch.clone, slab),
                                [39, 0, 17, 5])
    for (name, a), (_, b) in zip(ts.leaves(got), ts.leaves(want)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n", [1, 4096])
def test_walk_one_row_and_4096_rows(n):
    """One row (the pool's _slice_row) and a 4,096-row gather widened to x2
    (the JAX package's gather, then widen_state), from random states."""
    tst, jst = _random_state(4096, 0, n)
    if n == 1:
        assert_states_equal(trh.rehome_walk_plain(tst, [4000], _layout(0)),
                            jres._slice_row(jst, 4000))
        return
    rows = np.random.default_rng(3).permutation(4096)
    want = js.widen_state(_jax_gather(jst, rows), _layout(1))
    assert_states_equal(trh.rehome_walk_plain(tst, rows, _layout(1)), want)
    assert_states_equal(ts.rehome_plain(tst, rows, _layout(1)), want)


def _shifted(s, offset):
    """s with every tensor moved to `offset` bytes past a 16-byte boundary,
    rounded to a multiple of its element size (bools at the offset itself)."""
    def one(t):
        size = t.element_size()
        off = offset - offset % size if offset >= size else (size if offset else 0)
        buf = torch.zeros(t.numel() * size + 64, dtype=torch.uint8)
        at = (16 - buf.data_ptr() % 16) % 16 + off
        view = buf[at:at + t.numel() * size].view(t.dtype).view(t.shape)
        view.copy_(t)
        return view
    return ts.map_state(one, s)


@pytest.mark.parametrize("offset,units", [(0, {1, 4, 8, 16}), (1, {1, 4, 8}), (2, {1, 2, 4, 8}),
                                          (4, {1, 4, 8}), (8, {1, 4, 8})])
def test_walk_units_follow_alignment(replayed, offset, units):
    """Whole rows move in 16-byte units only where every row and both
    pointers are 16-byte aligned, else in the largest of 8, 4 and 2 that
    fits, else an element a unit; the result is the same at every
    alignment."""
    jst, tst = replayed[0]
    src = _shifted(tst, offset)
    dst = _shifted(ts.init_state(9, DEFAULT_LAYOUT, "cpu"), offset)
    table, _ = trh.work_table(DEFAULT_LAYOUT, DEFAULT_LAYOUT, 9,
                              [t.data_ptr() for _, t in ts.leaves(src)],
                              [t.data_ptr() for _, t in ts.leaves(dst)])
    assert {w.unit for w in table} == units and all(w.whole for w in table)
    rows = [11, -1, 0, 5, 5, 2, -1, 7, 3]
    got = trh.rehome_walk_plain(src, rows, DEFAULT_LAYOUT, dst, range(9))
    assert_states_equal(got, jres._stack_states(
        [jres._slice_row(jst, r) if r >= 0 else js.init_state(1, DEFAULT_LAYOUT) for r in rows]))


@pytest.mark.parametrize("src,dst,n", [(0, 0, 64), (0, 1, 64), (2, 0, 4096), (1, 1, 1)])
def test_work_table_covers_every_unit_once(src, dst, n):
    """Each field's blocks hold its n x units units (the last one partly),
    fields follow in csrc/state.cuh order from block 0, rows move whole
    (in units up to 16 bytes) exactly where the field's capacity is the
    same in and out, and at 64 rows of the base layout the launch fits the
    H100 in one wave (132 SMs, 16 blocks of REHOME_THREADS an SM)."""
    table, blocks = trh.work_table(_layout(src), _layout(dst), n)
    per_block = trh.REHOME_THREADS * trh.REHOME_ITEMS
    ends = [w.first_block for w in table[1:]] + [blocks]
    assert table[0].first_block == 0
    for w, end, d_in, d_out in zip(table, ends, trh._dims(_layout(src)), trh._dims(_layout(dst))):
        assert (end - w.first_block) == -(-n * w.units // per_block)
        assert w.whole == (d_in == d_out)
        assert w.unit in ((1, 2, 4, 8, 16) if w.whole else (1, 4, 8))
    assert all(w.whole for w in table) == (src == dst)
    if (src, dst, n) == (0, 0, 64):
        assert len(table) == 66 and blocks <= 132 * 16


def test_rehome_constants_are_the_kernels():
    """REHOME_THREADS and REHOME_ITEMS are csrc/rehome.cu's G_THREADS and
    G_ITEMS."""
    import pathlib
    import re

    src = (pathlib.Path(trh.__file__).parents[1] / "csrc" / "rehome.cu").read_text()
    consts = dict(re.findall(r"constexpr int (G_\w+) = (\d+);", src))
    assert (int(consts["G_THREADS"]), int(consts["G_ITEMS"])) == (trh.REHOME_THREADS,
                                                                  trh.REHOME_ITEMS)


# --- kernel G compiled for the host: csrc/rehome.cu's own work table and
# walk, every block and thread of the grid run in turn (the kernel has no
# barrier), on CPU tensors. The card's compile and launch are held by
# chip_smoke.py alone.

G_HARNESS = r"""
extern "C" long long host_rehome(const void* src_table, const int* cin, int cin_b, int cin_kv,
                                 const void* dst_table, const int* cout, int cout_b, int cout_kv,
                                 const int64_t* src_rows, const int64_t* dst_rows, int64_t n,
                                 const int64_t* init, const int* sizes, int32_t* table) {
  FieldTable ft;
  for (int f = 0; f < NUM_FIELDS; ++f) {
    ft.init[f] = init[f];
    ft.size[f] = static_cast<int8_t>(sizes[f]);
  }
  const StatePtrs S = state_from(src_table), D = state_from(dst_table);
  const Caps ci = caps_from(cin, cin_b, cin_kv), co = caps_from(cout, cout_b, cout_kv);
  const int64_t blocks = work_table(S, ci, D, co, n, ft);
  if (blocks < 0) return -1;
  for (int f = 0; f < NUM_FIELDS; ++f) {
    table[4 * f] = ft.unit[f];
    table[4 * f + 1] = ft.whole[f];
    table[4 * f + 2] = ft.units[f];
    table[4 * f + 3] = ft.first_block[f];
  }
  for (int64_t b = 0; b < blocks; ++b)
    for (unsigned t = 0; t < G_THREADS; ++t) {
      blockIdx.x = static_cast<unsigned>(b);
      threadIdx.x = t;
      rehome_kernel(S, ci, D, co, src_rows, dst_rows, static_cast<uint32_t>(n), ft);
    }
  return blocks;
}
"""


@pytest.fixture(scope="module")
def host_g(tmp_path_factory):
    import ctypes

    from tests.torch_parity import host_kernel

    lib = host_kernel(tmp_path_factory.mktemp("rehome"), "rehome.cu", 'extern "C"', G_HARNESS)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_rehome.restype = ctypes.c_longlong
    lib.host_rehome.argtypes = [P, P, I, I, P, P, I, I, P, P, ctypes.c_int64, P, P, P]
    return lib


def _host_rehome(lib, src, rows, lay, dst=None, dst_rows=None):
    """Kernel G compiled for the host: out row i = src[rows[i]] at `lay`,
    into a new state whose every slot first holds a value the kernel must
    overwrite, or into `dst` at dst_rows. Returns (the state, its work
    table as trh.FieldWork entries, the launch's blocks)."""
    import ctypes

    from cadence_tpu_torch.ops import _build

    n = len(rows)
    if dst is None:
        dst = ts.init_state(n, lay, "cpu")
        for _, t in ts.leaves(dst):
            t.fill_(True if t.dtype == torch.bool else 77)
        dst_rows = range(n)
    ptrs = lambda s: (ctypes.c_uint64 * 66)(*[t.data_ptr() for _, t in ts.leaves(s)])  # noqa: E731
    r = torch.tensor(list(rows), dtype=torch.int64)
    d = torch.tensor(list(dst_rows), dtype=torch.int64)
    init, sizes = trh._field_table()
    table = torch.zeros(66 * 4, dtype=torch.int32)
    li = ts.layout_of(src)
    blocks = lib.host_rehome(ptrs(src), _build.caps(li), li.max_branches,
                             li.max_version_history_items, ptrs(dst), _build.caps(lay),
                             lay.max_branches, lay.max_version_history_items, r.data_ptr(),
                             d.data_ptr(), n, init, sizes, table.data_ptr())
    assert blocks > 0
    work = [trh.FieldWork(int(u), bool(w), int(k), int(b))
            for u, w, k, b in table.view(66, 4).tolist()]
    return dst, work, blocks


def _python_table(src, dst, n):
    return trh.work_table(ts.layout_of(src), ts.layout_of(dst), n,
                          [t.data_ptr() for _, t in ts.leaves(src)],
                          [t.data_ptr() for _, t in ts.leaves(dst)])


@pytest.mark.parametrize("dst", [0, 1, 2])
@pytest.mark.parametrize("src", [0, 1, 2])
def test_host_kernel_equals_jax_widen_and_narrow(host_g, replayed, src, dst):
    """x1, x2 and x4 in both directions and at the same layout: the kernel's
    rows equal the JAX package's widen_state / narrow_state, and its work
    table is work_table's, entry for entry."""
    jst, tst = replayed[src]
    lay = _layout(dst)
    fn_j = js.widen_state if dst >= src else js.narrow_state
    got, work, blocks = _host_rehome(host_g, tst, range(W), lay)
    assert_states_equal(got, fn_j(jst, lay))
    assert (work, blocks) == _python_table(tst, got, W)


@pytest.mark.parametrize("out_rung", [0, 1])
def test_host_kernel_scatter_into_a_larger_slab(host_g, replayed, out_rung):
    """Rows and an init row scattered into a 40-row slab, at the same layout
    (whole rows) and widened (an element a unit): equal to rehome_plain,
    every other slab row left as it was."""
    _, tst = replayed[0]
    lay = _layout(out_rung)
    slab, _ = _random_state(40, out_rung, 11)
    want = ts.rehome_plain(tst, [4, -1, 2, 11], lay, ts.map_state(torch.clone, slab),
                           [39, 0, 17, 5])
    got, work, blocks = _host_rehome(host_g, tst, [4, -1, 2, 11], lay,
                                     ts.map_state(torch.clone, slab), [39, 0, 17, 5])
    for (name, a), (_, b) in zip(ts.leaves(got), ts.leaves(want)):
        assert torch.equal(a, b), name
    assert all(w.whole for w in work) == (out_rung == 0)


@pytest.mark.parametrize("n", [1, 4096])
def test_host_kernel_one_row_and_4096_rows(host_g, n):
    """One row (the pool's _slice_row) and a 4,096-row gather widened to x2
    (the JAX package's gather, then widen_state), from random states."""
    tst, jst = _random_state(4096, 0, n)
    if n == 1:
        got, _, _ = _host_rehome(host_g, tst, [4000], _layout(0))
        assert_states_equal(got, jres._slice_row(jst, 4000))
        return
    rows = np.random.default_rng(3).permutation(4096)
    got, work, blocks = _host_rehome(host_g, tst, rows, _layout(1))
    assert_states_equal(got, js.widen_state(_jax_gather(jst, rows), _layout(1)))
    assert (work, blocks) == _python_table(tst, got, 4096)


@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8])
def test_host_kernel_units_follow_alignment(host_g, replayed, offset):
    """Tensors moved off their 16-byte boundaries: the kernel picks the
    units work_table gives for those pointers (16 bytes only where every
    row and both pointers allow), and the rows equal the JAX package's
    _stack_states of _slice_row rows and init rows."""
    jst, tst = replayed[0]
    src = _shifted(tst, offset)
    dst = _shifted(ts.init_state(9, DEFAULT_LAYOUT, "cpu"), offset)
    rows = [11, -1, 0, 5, 5, 2, -1, 7, 3]
    got, work, blocks = _host_rehome(host_g, src, rows, DEFAULT_LAYOUT, dst, range(9))
    assert (work, blocks) == _python_table(src, dst, 9)
    assert_states_equal(got, jres._stack_states(
        [jres._slice_row(jst, r) if r >= 0 else js.init_state(1, DEFAULT_LAYOUT) for r in rows]))
