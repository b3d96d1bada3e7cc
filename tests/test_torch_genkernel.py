"""The port's device generator (cadence_tpu_torch/ops/genkernel.py) against
the JAX package's ops/genkernel.py, on the CPU, where every entry point
runs the plain version: the same (seed, first index, W, E) give the same
lanes, the same fused payload rows, errors and CRCs, sharded or not, and
the same hash and die values on int64's edges. Every value is an integer:
the tolerance is 0. Shapes are tests/test_genkernel.py's (W=32, E=120)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cadence_tpu.ops import genkernel as jg
from cadence_tpu.core.checksum import crc32_of_rows
from cadence_tpu_torch.core.checksum import STICKY_ROW_INDEX, payload_row
from cadence_tpu_torch.core.enums import EventType, WorkflowState
from cadence_tpu_torch.ops import genkernel as tg
from cadence_tpu_torch.ops.encode import decode_lanes
from cadence_tpu_torch.ops.replay import replay_to_payload
from cadence_tpu_torch.oracle.state_builder import StateBuilder
from cadence_tpu_torch.parallel.mesh import Mesh

W, E = 32, 120
E_SHARDED = 60
SEEDS = (42, 43)
I64_MIN, I64_MAX = int(np.iinfo(np.int64).min), int(np.iinfo(np.int64).max)
CPU = "cpu"


@pytest.fixture(scope="module")
def jax_lanes():
    return {seed: np.asarray(jg.generate_lanes(seed, 0, W, E)) for seed in SEEDS}


@pytest.fixture(scope="module")
def port_lanes():
    return {seed: tg.generate_lanes(seed, 0, W, E, device=CPU).numpy() for seed in SEEDS}


@pytest.fixture(scope="module")
def jax_fused():
    return {seed: tuple(map(np.asarray, jg.generate_and_replay(seed, 0, W, E))) for seed in SEEDS}


@pytest.fixture(scope="module")
def port_fused():
    return {seed: tuple(t.numpy() for t in tg.generate_and_replay(seed, 0, W, E, device=CPU))
            for seed in SEEDS}


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_lanes_equal(seed, jax_lanes, port_lanes):
    assert port_lanes[seed].dtype == np.int64 and port_lanes[seed].shape == (W, E, 18)
    assert np.array_equal(port_lanes[seed], jax_lanes[seed])


def test_reproducible_and_distinct(port_lanes):
    lanes = port_lanes[42]
    assert np.array_equal(tg.generate_lanes(42, 0, W, E, device=CPU).numpy(), lanes)
    assert len({lanes[i].tobytes() for i in range(W)}) == W
    assert not np.array_equal(port_lanes[43], lanes)


def test_every_slot_is_a_real_event_and_histories_close(port_lanes):
    lanes = port_lanes[42]
    assert (lanes[:, :, 0] == np.arange(1, E + 1)[None, :]).all()
    assert (lanes[:, 0, 1] == int(EventType.WorkflowExecutionStarted)).all()
    assert (lanes[:, 1, 1] == int(EventType.DecisionTaskScheduled)).all()
    assert (lanes[:, -1, 1] == int(EventType.WorkflowExecutionCompleted)).all()


@pytest.mark.parametrize("seed", [I64_MIN, I64_MAX, I64_MIN + 1, -1, -5, 0, 42, 20260730])
def test_mix_equal_on_int64_edges(seed):
    w = np.array([0, 1, -1, 7, I64_MIN, I64_MAX, 123456789, -987654321], dtype=np.int64)
    for step, salt in ((0, 17), (1, 1), (999, 4), (123456, 3)):
        want = np.asarray(jg._mix(jnp.int64(seed), jnp.asarray(w), step, salt))
        got = tg._mix(seed, torch.from_numpy(w), step, salt).numpy()
        assert np.array_equal(got, want), (seed, step, salt)
    # a seed given as a tensor hashes as the Python int does
    got_t = tg._mix(torch.tensor(seed, dtype=torch.int64), torch.from_numpy(w), 5, 2)
    assert np.array_equal(got_t.numpy(), tg._mix(seed, torch.from_numpy(w), 5, 2).numpy())


@pytest.mark.parametrize("n", [5000, 6600, 16, 8, 1_000_000])
def test_die_equal_on_int64_edges(n):
    r = np.array([I64_MIN, I64_MIN + 1, I64_MAX, -1, -8, -808, 0, 1, 4999, 5000, -5001],
                 dtype=np.int64)
    want = np.asarray(jg._die(jnp.asarray(r), n))
    got = tg._die(torch.from_numpy(r), n).numpy()
    assert np.array_equal(got, want)
    assert ((got >= 0) & (got < n)).all()


def test_die_of_int64_min_is_floor_modulo():
    """abs(INT64_MIN) wraps to INT64_MIN, and the floor modulo takes the
    divisor's sign: 4192, where C's truncating % gives -808."""
    assert int(jg._die(jnp.int64(I64_MIN), 5000)) == 4192
    assert int(tg._die(torch.tensor([I64_MIN]), 5000)[0]) == 4192
    assert int(jnp.int64(-8) >> 1) == -4 and int(torch.tensor(-8) >> 1) == -4


@pytest.mark.parametrize("seed", [I64_MIN, -3, 42])
def test_init_gen_state_equal(seed):
    want = jg.init_gen_state(W, seed, 5)
    got = tg.init_gen_state(W, seed, 5, device=CPU)
    for name in jg.GenState._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_first_equal():
    rng = np.random.default_rng(4)
    mask = rng.random((64, 4)) < 0.3
    mask[:5] = False  # rows with nothing set select nothing
    onehot_j, any_j = map(np.asarray, jg._first(jnp.asarray(mask)))
    onehot_t, any_t = tg._first(torch.from_numpy(mask))
    assert np.array_equal(onehot_t.numpy(), onehot_j) and np.array_equal(any_t.numpy(), any_j)
    assert not onehot_t[:5].any()


@pytest.mark.parametrize("split", [8, 24])
def test_first_index_seams(split, jax_lanes):
    """Workflow w depends only on (seed, w): chunks at any first index
    reproduce the JAX package's one-shot lanes."""
    lo = tg.generate_lanes(42, 0, split, E, device=CPU).numpy()
    hi = tg.generate_lanes(42, split, W - split, E, device=CPU).numpy()
    assert np.array_equal(np.concatenate([lo, hi]), jax_lanes[42])


def test_fused_seam_at_8(jax_fused):
    """0 + 8 = 16: two fused chunks give the one-shot rows."""
    lo, _ = tg.generate_and_replay(42, 0, 8, E, device=CPU)
    hi, _ = tg.generate_and_replay(42, 8, 8, E, device=CPU)
    assert np.array_equal(torch.cat([lo, hi]).numpy(), jax_fused[42][0][:16])


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_rows_and_errors_equal(seed, jax_fused, port_fused):
    rows_j, err_j = jax_fused[seed]
    rows_t, err_t = port_fused[seed]
    assert (err_j == 0).all()
    assert np.array_equal(rows_t, rows_j) and np.array_equal(err_t, err_j)


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_crc_equal(seed, jax_fused):
    rows_j, err_j = jax_fused[seed]
    crc_j = crc32_of_rows(rows_j)  # jg.generate_and_replay_crc's contract
    crc_t, err_t = tg.generate_and_replay_crc(seed, 0, W, E, device=CPU)
    assert np.array_equal(crc_t.numpy().astype(np.uint32), crc_j)
    assert np.array_equal(err_t.numpy(), err_j)


def test_fused_equals_materialized(port_lanes, port_fused):
    rows_m, err_m = replay_to_payload(port_lanes[42], device=CPU)
    rows_f, err_f = port_fused[42]
    assert np.array_equal(rows_f, rows_m.numpy()) and np.array_equal(err_f, err_m.numpy())


def test_fused_state_equals_the_plain_loop_in_place():
    from cadence_tpu_torch.ops.state import init_state, leaves

    s = init_state(8, device=CPU)
    fresh = init_state(8, device=CPU)
    out = tg.gen_scan(s, 3, 100, 40)
    assert out is s
    want = tg.gen_scan_plain(fresh, 3, 100, 40)
    for (name, a), (_, b) in zip(leaves(s), leaves(want)):
        assert torch.equal(a, b), name
    assert int(fresh.next_event_id[0]) == 1  # the plain loop left its input as it was


@pytest.fixture(scope="module")
def jax_sharded():
    import jax

    from cadence_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:8])  # conftest forces the 8-device CPU mesh
    rows, err = map(np.asarray, jg.generate_and_replay_sharded(11, 0, W, E_SHARDED, mesh))
    # the CRC form's contract: the hash of these rows (the JAX package's
    # generate_and_replay_sharded_crc does not trace under this JAX's
    # shard_map varying-axes typing, so its rows are hashed here)
    return rows, err, crc32_of_rows(rows), err


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_equal(n, jax_sharded):
    rows_j, err_j, _, _ = jax_sharded
    rows_t, err_t = tg.generate_and_replay_sharded(11, 0, W, E_SHARDED, Mesh([CPU] * n))
    assert np.array_equal(rows_t.numpy(), rows_j) and np.array_equal(err_t.numpy(), err_j)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_crc_equal(n, jax_sharded):
    _, _, crc_j, err_j = jax_sharded
    crc_t, err_t = tg.generate_and_replay_sharded_crc(11, 0, W, E_SHARDED, Mesh([CPU] * n))
    assert np.array_equal(crc_t.numpy().astype(np.uint32), crc_j)
    assert np.array_equal(err_t.numpy(), err_j)


@pytest.mark.parametrize("fn", [tg.generate_and_replay_sharded, tg.generate_and_replay_sharded_crc])
def test_sharded_raises_when_w_does_not_split(fn):
    with pytest.raises(ValueError, match="not divisible"):
        fn(11, 0, 65, E, Mesh([CPU] * 8))


@pytest.mark.parametrize("seed", SEEDS)
def test_oracle_parity(seed, port_lanes, port_fused):
    rows, errors = port_fused[seed]
    assert (errors == 0).all()
    for i in range(W):
        ms = StateBuilder().replay_history(decode_lanes(port_lanes[seed][i]))
        expected = payload_row(ms)
        expected[STICKY_ROW_INDEX] = 0
        assert np.array_equal(rows[i], expected), f"workflow {i} diverged"
        assert ms.execution_info.state == WorkflowState.Completed
        assert not ms.pending_activity_info_ids
        assert not ms.pending_timer_info_ids
        assert not ms.pending_child_execution_info_ids


@pytest.mark.parametrize("call", [
    lambda: tg.generate_lanes(1, 0, 4, 8),
    lambda: tg.generate_and_replay(1, 0, 4, 8),
    lambda: tg.generate_and_replay_crc(1, 0, 4, 8),
    lambda: tg.generate_and_replay_state(1, 0, 4, 8),
], ids=["generate_lanes", "generate_and_replay", "generate_and_replay_crc", "state"])
def test_entry_points_raise_without_cuda(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_launches_refuse_the_cpu():
    from cadence_tpu_torch.ops import _build

    before = dict(_build.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        tg.generate_lanes_launch(1, 0, 4, 8, device=CPU)
    tg.generate_lanes(1, 0, 4, 8, device=CPU)
    tg.generate_and_replay(1, 0, 4, 8, device=CPU)
    assert _build.launches == before  # the plain versions never count


# --- kernel A's generator reader: the draws made ahead, one tile at a time ---

def _jax_dice(seed, first, n, e0, steps):
    """{field: [steps, n]} from the JAX package's _mix and _die, as the
    generator step uses them (ts adds die(r3, 5000) + 1 ms; the attribute
    lanes add their offsets)."""
    w = jnp.arange(n, dtype=jnp.int64) + jnp.int64(first)
    out = {name: [] for name in tg.DICE_FIELDS}
    for s in range(steps):
        r = {salt: jg._mix(jnp.int64(seed), w, e0 + s, salt) for salt in (1, 2, 3, 4)}
        for name, (salt, mod, added, _lo, _bits) in tg.DICE_FIELDS.items():
            out[name].append(np.asarray(jg._die(r[salt], mod)) + added)
    return {name: np.stack(v) for name, v in out.items()}


@pytest.mark.parametrize("seed,first,n,e0,steps", [
    (42, 0, tg.GEN_WF, 0, tg.GEN_TILE),                   # one block's first tile
    (42, tg.GEN_WF - 3, 6, tg.GEN_TILE - 2, 5),           # a block seam and a tile seam
    (20260730, 999_990, 20, 1000 - tg.GEN_TILE, tg.GEN_TILE),  # the last tile of 1,000
    (I64_MIN, 7, 9, 3, 4),
    (I64_MAX, 123_456, 5, 0, 2),
])
def test_dice_tile_as_jax(seed, first, n, e0, steps):
    words = tg.pack_dice_plain(seed, first, n, e0, steps)
    assert words.shape == (steps, n) and bool((words >> 56 == 0).all())
    got = tg.unpack_dice(words)
    want = _jax_dice(seed, first, n, e0, steps)
    for name in tg.DICE_FIELDS:
        assert np.array_equal(got[name].numpy(), want[name]), name


def test_dice_tiles_join_at_any_seam():
    """Workflow w's draws at step e depend on (seed, w, e) alone: tiles cut
    at any first index or step give the one-shot tile's words."""
    whole = tg.pack_dice_plain(9, 100, 48, 0, 24)
    for cut_w, cut_e in ((tg.GEN_WF, tg.GEN_TILE), (5, 1), (47, 23)):
        top = torch.cat([tg.pack_dice_plain(9, 100, cut_w, 0, cut_e),
                         tg.pack_dice_plain(9, 100 + cut_w, 48 - cut_w, 0, cut_e)], dim=1)
        bottom = torch.cat([tg.pack_dice_plain(9, 100, cut_w, cut_e, 24 - cut_e),
                            tg.pack_dice_plain(9, 100 + cut_w, 48 - cut_w, cut_e, 24 - cut_e)],
                           dim=1)
        assert torch.equal(torch.cat([top, bottom]), whole), (cut_w, cut_e)


def test_dice_fields_fit_their_bits():
    """Each draw's largest value fits its field, and the fields tile 56 bits."""
    lo = 0
    for name, (_salt, mod, added, low, bits) in tg.DICE_FIELDS.items():
        assert low == lo and (mod - 1 + (added if name == "ts_ms" else 0)) < 1 << bits, name
        lo += bits
    assert lo == 56


def test_dice_drive_the_plain_step():
    """The lanes of gen_step come out of the unpacked words: the timestamp
    advances by ts_ms milliseconds, and an ActivityTaskScheduled event
    carries sched_to_start, sched_to_close and start_to_close."""
    lanes = tg.generate_lanes(42, 0, W, E, device=CPU)
    words = tg.pack_dice_plain(42, 0, W, 0, E)
    d = {k: v.T.numpy() for k, v in tg.unpack_dice(words).items()}
    ts = lanes[:, :, 3].numpy()
    assert np.array_equal(ts[:, 1:] - ts[:, :-1], d["ts_ms"][:, 1:] * tg.NANOS_MS)
    sched = lanes[:, :, 1].numpy() == int(EventType.ActivityTaskScheduled)
    assert sched.sum() > 20
    for lane, name in ((8, "sched_to_start"), (9, "sched_to_close"), (10, "start_to_close")):
        assert np.array_equal(lanes[:, :, lane].numpy()[sched], d[name][sched]), name


def test_replay_gen_refuses_tables_past_its_masks():
    """The generator reader holds each table's occupancy in 64 bits: a
    layout with more activity, timer or child slots is refused before any
    launch."""
    from cadence_tpu_torch.ops.state import init_state, widen_layout

    wide = init_state(2, widen_layout(tg.DEFAULT_LAYOUT, 8), device=CPU)
    with pytest.raises(ValueError, match="at most 64"):
        tg.gen_launch(wide, 1, 0, 4)
    assert tg.GEN_MAX_SLOTS == 64


def _csrc(name: str) -> str:
    import pathlib

    return (pathlib.Path(tg.__file__).parents[1] / "csrc" / name).read_text()


def test_gen_tile_constants_are_the_kernels():
    """GEN_WF and GEN_TILE are csrc/replay_gen.cu's, and GEN_MAX_SLOTS is
    replay_gen.cuh's GEN_MAX_K."""
    import re

    consts = dict(re.findall(r"constexpr int (GEN_\w+) = (\d+);",
                             _csrc("replay_gen.cu") + _csrc("replay_gen.cuh")))
    assert (int(consts["GEN_WF"]), int(consts["GEN_TILE"])) == (tg.GEN_WF, tg.GEN_TILE)
    assert int(consts["GEN_MAX_K"]) == tg.GEN_MAX_SLOTS


def test_dice_layout_is_the_kernels():
    """DICE_FIELDS is genkernel.cuh's draws bit for bit: each field's salt
    and modulus as LazyDice draws it, its low bit as pack_dice shifts it,
    and its width and offset as PackedDice reads it."""
    import re

    src = _csrc("genkernel.cuh")
    lazy = src[src.index("struct LazyDice"):src.index("struct PackedDice")]
    drawn = {name: (int(r) + 1, int(n), int(pre or post or 0)) for name, pre, r, n, post in
             re.findall(r"int64_t (\w+)\(\) const \{ return (?:(\d+) \+ )?die\(r(\d), "
                        r"(\d+)\)(?: \+ (\d+))?; \}", lazy)}
    pack = src[src.index("uint64_t pack_dice"):src.index("struct PackedDice")]
    pack = pack[pack.index("return"):]
    shifted = {}
    for term in pack[:pack.index(";")].split("|"):
        m = re.search(r"u\(d\.(\w+)\(\)\)(?: << (\d+))?", term)
        if m:  # a LazyDice draw, by name
            salt, n, _ = drawn[m.group(1)]
        else:  # die(d.rX, n) in place
            m = re.search(r"u\(die\(d\.r(\d), (\d+)\)\) << (\d+)", term)
            salt, n = int(m.group(1)) + 1, int(m.group(2))
        shifted[(salt, n)] = int(m.groups()[-1] or 0)
    packed = src[src.index("struct PackedDice"):]
    packed = packed[:packed.index("};")]
    read = {name: (int(add or 0), int(lo), int(bits)) for name, add, lo, bits in
            re.findall(r"int64_t (\w+)\(\) const \{ return (?:(\d+) \+ )?bits\((\d+), "
                       r"(\d+)\); \}", packed)}
    assert len(shifted) == len(tg.DICE_FIELDS)
    for name, (salt, n, added, lo, bits) in tg.DICE_FIELDS.items():
        assert shifted[(salt, n)] == lo, name
        # ts_ms is packed as it is used (+ 1 in LazyDice); the rest add on read
        stored = added if name == "ts_ms" else 0
        assert read[name] == (added - stored, lo, bits), name
        if name in drawn:
            assert drawn[name] == (salt, n, added), name


# --- kernel I: blocks of LANES_WF workflows, steps in tiles of LANES_TILE ---

T = tg.LANES_TILE
TILE_W = (1, tg.LANES_WF - 1, tg.LANES_WF, tg.LANES_WF + 1)
TILE_E = (1, T - 1, T, T + 1, 200)
_JAX_TILE_LANES = {}


def _jax_lanes_33(E):
    """The JAX package's lanes of workflows 0..32 at E steps (a workflow's
    lanes depend on (seed, index, E) alone, so narrower blocks are rows of
    these), made once an E."""
    if E not in _JAX_TILE_LANES:
        _JAX_TILE_LANES[E] = np.asarray(jg.generate_lanes(42, 0, tg.LANES_WF + 1, E))
    return _JAX_TILE_LANES[E]


@pytest.mark.parametrize("E", TILE_E)
@pytest.mark.parametrize("nw", TILE_W)
def test_tiled_lanes_equal_jax(nw, E):
    """One block and a part (33), a full block (32), one short (31) and one
    workflow; one step, a tile less one, a tile, a tile and one, 200 steps:
    kernel I's tiling gives the JAX package's lanes."""
    got = tg.generate_lanes_tiled_plain(42, 0, nw, E, device=CPU).numpy()
    assert got.shape == (nw, E, 18)
    assert np.array_equal(got, _jax_lanes_33(E)[:nw])


@pytest.mark.parametrize("first", [tg.LANES_WF - 1, tg.LANES_WF, 1_000_003, 2 ** 40])
def test_tiled_lanes_first_index_seams(first):
    """Blocks that start at any global workflow index give the JAX
    package's lanes of those workflows."""
    E = T + 3
    want = np.asarray(jg.generate_lanes(7, first, 40, E))
    assert np.array_equal(tg.generate_lanes_tiled_plain(7, first, 40, E, device=CPU).numpy(),
                          want)


def test_step_dice_are_the_packed_words():
    """The draws gen_step makes for itself are the packed words' (with
    step 0's started_a0 made once a workflow), so the tiled and the plain
    steps see the same values."""
    for step in (0, 1, 77):
        made = tg.step_dice(42, 5, 9, step, CPU)
        packed = tg.unpack_dice(tg.pack_dice_plain(42, 5, 9, step, 1)[0])
        for name in tg.DICE_FIELDS:
            assert torch.equal(made[name], packed[name]), (step, name)
    w = torch.arange(9, dtype=torch.int64) + 5
    assert torch.equal(tg.step_dice(42, 5, 9, 0, CPU)["started_a0"],
                       600 + tg._die(tg._mix(42, w, 0, 3), 6600))


def test_lanes_tile_constants_are_the_kernels():
    """LANES_WF and LANES_TILE are csrc/genkernel.cu's."""
    import re

    consts = dict(re.findall(r"constexpr int (LANES_\w+) = (\d+);", _csrc("genkernel.cu")))
    assert (int(consts["LANES_WF"]), int(consts["LANES_TILE"])) == (tg.LANES_WF, tg.LANES_TILE)


# --- kernel I compiled for the host: csrc/genkernel.cu's own phases
# (draws packed per tile, choose and act_all stepping into the shared tile,
# its 16-byte stores), each block's phases in order and every thread of a
# phase before the next, as the kernel's barriers order them. The card's
# compile and launch are held by chip_smoke.py alone.

I_HARNESS = r"""
extern "C" int host_gen_lanes(int64_t seed, int64_t first_index, int64_t W, int64_t E,
                              int64_t* out) {
  std::vector<int64_t> smem(2 * TILE_WORDS + 2 * DICE_WORDS, 0x5a5a5a5a);
  std::vector<Stepper> st(LANES_THREADS);
  uint64_t* dice = reinterpret_cast<uint64_t*>(smem.data() + 2 * TILE_WORDS);
  const int64_t tiles = (E + LANES_TILE - 1) / LANES_TILE;
  for (int64_t w0 = 0; w0 < W; w0 += LANES_WF) {
    const int nw = W - w0 < LANES_WF ? static_cast<int>(W - w0) : LANES_WF;
    for (int64_t k = -1; k <= tiles; ++k)
      for (int t = 0; t < LANES_THREADS; ++t)
        lanes_phase(k, tiles, t, st[t], seed, first_index, w0, nw, E, smem.data(), dice, out);
  }
  return LANES_TILE;
}
"""


@pytest.fixture(scope="module")
def host_i(tmp_path_factory):
    import ctypes

    from tests.torch_parity import host_kernel

    lib = host_kernel(tmp_path_factory.mktemp("genkernel"), "genkernel.cu", "__global__",
                      I_HARNESS, close="}  // namespace\n")
    LL = ctypes.c_int64
    lib.host_gen_lanes.argtypes = [LL, LL, LL, LL, ctypes.c_void_p]
    return lib


def _host_lanes(lib, seed, first, nw, E):
    """Kernel I compiled for the host: [nw, E, 18] lanes, every word first
    set to a value the kernel must overwrite."""
    out = torch.full((nw, E, 18), -12345, dtype=torch.int64)
    assert lib.host_gen_lanes(tg._wrap(seed), first, nw, E, out.data_ptr()) == tg.LANES_TILE
    return out.numpy()


@pytest.mark.parametrize("E", TILE_E)
@pytest.mark.parametrize("nw", TILE_W)
def test_host_kernel_i_equals_jax(host_i, nw, E):
    """One block and a part, a full block, one short and one workflow; one
    step, a tile less one, a tile, a tile and one, 200 steps: the kernel's
    lanes are the JAX package's."""
    assert np.array_equal(_host_lanes(host_i, 42, 0, nw, E), _jax_lanes_33(E)[:nw])


@pytest.mark.parametrize("first", [tg.LANES_WF - 1, tg.LANES_WF, 1_000_003, 2 ** 40])
def test_host_kernel_i_first_index_seams(host_i, first):
    """Blocks that start at any global workflow index give the JAX
    package's lanes of those workflows."""
    E = T + 3
    assert np.array_equal(_host_lanes(host_i, 7, first, 40, E),
                          np.asarray(jg.generate_lanes(7, first, 40, E)))


@pytest.mark.parametrize("seed", [I64_MAX, I64_MIN, -5])
def test_host_kernel_i_seeds_on_int64_edges(host_i, seed):
    """Seeds on int64's edges, where the hashes wrap: the kernel's lanes are
    the plain version's (held to the JAX package above)."""
    assert np.array_equal(_host_lanes(host_i, seed, 5, 33, 40),
                          tg.generate_lanes_plain(seed, 5, 33, 40, device=CPU).numpy())
