"""Kernel E (csrc/wirec.cu, decode_wirec) compiled as host C++
(tests/torch_parity.py host_kernel) and run through the kernel's own warp
schedule, decode_warp: every warp of a chosen grid, its 32 lanes as
threads that meet at each __shfl_up_sync and __syncwarp, cp.async made at
its wait. Held, exactly, to the JAX package's ops/wirec.py decode_wirec on
the packed corpora and on random profiles and bytes: every width and
kind, several DELTA lanes, negative top bytes, 64-bit lanes whose sums
wrap, n_events of 0, E and inside a chunk, E at and around the chunk of 32
rows, W below and above the warps of a block, B not a multiple of 16 and
slabs at odd byte offsets. The card's compile and launch are held by
chip_smoke.py alone."""
import ctypes

import numpy as np
import pytest
import torch

from cadence_tpu.ops import wirec as jw
from cadence_tpu_torch.ops import wirec as tw
from tests.torch_parity import WIREC_KINDS, wirec_corpus

#: warps a block (E_WARPS in wirec.cu; test_block_shape holds it)
WARPS = 8
KINDS = (tw.KIND_CONST, tw.KIND_ABS, tw.KIND_DELTA, tw.KIND_TSREL_NZ)

HARNESS = r"""
using namespace cadence;

// Every warp of the launcher's grid, one after another, each warp's lanes
// side by side; `smem` is what a block finds (A5 bytes).
extern "C" void host_decode(const uint8_t* slab, const int64_t* bases, const int32_t* n_events,
                            int64_t* out, int64_t W, int64_t E, int B, int K,
                            const int64_t* profile) {
  const WirecProfile p = wirec_profile_from(profile);
  const DecodeArgs a{slab, bases, n_events, out, W, E, B, K};
  const size_t per_warp = warp_bytes(B, K);
  std::vector<uint64_t> smem((E_WARPS * per_warp + 7) / 8);
  host_pipes.clear();
  for (int64_t b = 0; b < grid_blocks(W); ++b) {
    blockIdx.x = static_cast<unsigned>(b);
    std::memset(smem.data(), 0xA5, smem.size() * 8);
    for (int w = 0; w < E_WARPS; ++w)
      host_warp([&](int lane) {
        threadIdx.x = w * 32 + lane;
        decode_warp(a, p, reinterpret_cast<uint8_t*>(smem.data()) + w * per_warp,
                    b * E_WARPS + w, lane);
      });
  }
}

extern "C" long long host_grid(long long W) { return grid_blocks(W); }
extern "C" int host_warps() { return E_WARPS; }
extern "C" long long host_warp_bytes(int B, int K) { return warp_bytes(B, K); }
"""


@pytest.fixture(scope="module")
def host_e(tmp_path_factory):
    from tests.torch_parity import host_kernel

    lib = host_kernel(tmp_path_factory.mktemp("wirec"), "wirec.cu",
                      "// The kernel and its launcher",
                      HARNESS, close="}  // namespace\n}  // namespace cadence\n")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_decode.restype = None
    lib.host_decode.argtypes = [P, P, P, P, L, L, I, I, P]
    lib.host_grid.restype = L
    lib.host_grid.argtypes = [L]
    lib.host_warp_bytes.restype = L
    lib.host_warp_bytes.argtypes = [I, I]
    return lib


def _host_decode(lib, slab, bases, n_events, profile, offset=0, seed=0):
    """The kernel's decode of one corpus on the host: the slab placed
    `offset` bytes into a buffer of random bytes (the 16-byte blocks the
    kernel copies hold bytes before and after it), every warp of the
    launcher's grid run. Returns [W, E, 18] int64."""
    W, E, B = slab.shape
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(0, 256, offset + slab.size + 32, dtype=np.uint8))
    placed = buf[offset:offset + slab.size].view(W, E, B)
    placed.copy_(torch.from_numpy(np.ascontiguousarray(slab)))
    bases_t = torch.from_numpy(np.ascontiguousarray(bases, dtype=np.int64))
    n_t = torch.from_numpy(np.ascontiguousarray(n_events, dtype=np.int32))
    out = torch.full((W, E, tw.NUM_LANES), 0x5A5A5A5A5A5A5A5A, dtype=torch.int64)
    assert out.data_ptr() % 16 == 0
    tw.check_profile(tuple(profile), B, bases_t.shape[1])
    table = tw.profile_table(profile)
    lib.host_decode(placed.data_ptr(), bases_t.data_ptr(), n_t.data_ptr(), out.data_ptr(), W, E,
                    B, bases_t.shape[1], ctypes.addressof(table))
    return out.numpy()


def _jax_profile(profile):
    return tuple(jw.LaneCode(e.lane, e.kind, e.offset, e.width, e.scale, e.const, e.base_index)
                 for e in profile)


#: the one shape every JAX decode here runs at, so JAX compiles its
#: operations once: a corpus is padded to it (workflows of zero bytes,
#: rows past its E, which no earlier row's value reads) and cut back
JAX_W, JAX_E = 32, 128


def _jax_decode(slab, bases, n_events, profile):
    W, E, B = slab.shape
    assert W <= JAX_W and E <= JAX_E
    big = np.zeros((JAX_W, JAX_E, B), dtype=np.uint8)
    big[:W, :E] = slab
    big_bases = np.zeros((JAX_W, bases.shape[1]), dtype=np.int64)
    big_bases[:W] = bases
    big_n = np.zeros(JAX_W, dtype=np.int32)
    big_n[:W] = n_events
    out = jw.decode_wirec(big, big_bases, big_n, _jax_profile(profile))
    return np.asarray(out)[:W, :E]


def _random_profile(rng, kinds=None):
    """A profile of 18 lanes with random kinds (each kind at least once,
    three DELTA lanes at least), widths 1-8 (each at least once where the
    lanes allow), offsets in order with gaps, scales up to 2^40 and bases
    in [0, K). Returns (profile, B, K)."""
    if kinds is None:
        kinds = [tw.KIND_DELTA] * 3 + list(KINDS) + list(rng.choice(KINDS, tw.NUM_LANES - 7))
        rng.shuffle(kinds)
    widths = [w for w in list(range(1, 9)) + list(rng.integers(1, 9, tw.NUM_LANES))]
    off, K, wi, entries = int(rng.integers(0, 3)), 0, 0, []
    for lane, kind in enumerate(kinds):
        if kind == tw.KIND_CONST:
            entries.append(tw.LaneCode(lane, kind, 0, 0, 1,
                                       int(rng.integers(-2**63, 2**63 - 1, dtype=np.int64)), -1))
            continue
        width = widths[wi]
        wi += 1
        scale = int(rng.choice([1, 3, 1000, int(rng.integers(1, 2**40))]))
        base = -1
        if kind in (tw.KIND_DELTA, tw.KIND_TSREL_NZ):
            base, K = K, K + 1
        entries.append(tw.LaneCode(lane, int(kind), off, width, scale, 0, base))
        off += width + int(rng.integers(0, 2))
    return tuple(entries), off + int(rng.integers(0, 2)), K


def _random_inputs(rng, W, E, B, K, n_events):
    """Random slab bytes (every top byte value, so negative ones too) and
    bases over the whole int64 range."""
    slab = rng.integers(0, 256, (W, E, B), dtype=np.uint8)
    bases = rng.integers(-2**63, 2**63 - 1, (W, K), dtype=np.int64, endpoint=True)
    return slab, bases, np.asarray(n_events, dtype=np.int32)


def test_block_shape(host_e):
    """The harness runs E_WARPS warps a block; a warp's shared bytes hold
    the 4,608-byte tile, the two carry slots and 16-byte stages."""
    assert host_e.host_warps() == WARPS
    for B, K in ((0, 0), (1, 1), (20, 4), (144, 18)):
        assert host_e.host_warp_bytes(B, K) % 16 == 0
        assert host_e.host_warp_bytes(B, K) >= 32 * 144 + 2 * 18 * 8 + 2 * (32 * B + 15)


@pytest.mark.parametrize("W,want", [(1, 1), (3, 1), (8, 1), (9, 2), (64, 8), (4096, 512),
                                    (40960, 5120)])
def test_grid_blocks(host_e, W, want):
    """A warp a workflow: ceil(W / warps a block) blocks."""
    assert host_e.host_grid(W) == want


@pytest.mark.parametrize("kind", WIREC_KINDS)
def test_packed_corpora_equal_jax(host_e, kind):
    """Each packed corpus (4 to 16 workflows: one block or two)."""
    c = jw.pack_wirec(wirec_corpus(kind))
    got = _host_decode(host_e, c.slab, c.bases, c.n_events, c.profile)
    np.testing.assert_array_equal(got, _jax_decode(c.slab, c.bases, c.n_events, c.profile))


@pytest.mark.parametrize("E", [1, 31, 32, 33, 123])
@pytest.mark.parametrize("W", [3, 9, 17], ids=["W-below-a-block", "W-above-a-block",
                                              "W-over-two-blocks"])
def test_random_profiles_equal_jax(host_e, E, W):
    """Random profiles and bytes: n_events 0, E, inside a chunk and past E,
    beside random counts; the slab 0, 5 or 10 bytes into its buffer."""
    rng = np.random.default_rng(1000 * E + W)
    profile, B, K = _random_profile(rng)
    n = [0, E, max(0, E // 2 - 1), E + 5] + list(rng.integers(-1, E + 1, W))
    slab, bases, n_events = _random_inputs(rng, W, E, B, K, n[:W])
    want = _jax_decode(slab, bases, n_events, profile)
    offset = (E + W) % 3 * 5
    got = _host_decode(host_e, slab, bases, n_events, profile, offset=offset, seed=E)
    np.testing.assert_array_equal(got, want, err_msg=f"B {B}, K {K}, offset {offset}")


@pytest.mark.parametrize("offset", [1, 3, 7, 8, 15])
def test_odd_slab_offsets_equal_jax(host_e, offset):
    """A slab whose base is not 16-byte aligned: the copies start at the
    boundary before it and each row is read from its own byte on."""
    rng = np.random.default_rng(offset)
    profile, B, K = _random_profile(rng)
    W, E = 6, 45
    slab, bases, n_events = _random_inputs(rng, W, E, B, K, [E, 44, 32, 31, 1, 0])
    got = _host_decode(host_e, slab, bases, n_events, profile, offset=offset, seed=offset)
    np.testing.assert_array_equal(got, _jax_decode(slab, bases, n_events, profile))


@pytest.mark.parametrize("B", [1, 13, 16, 17, 37])
def test_row_widths_equal_jax(host_e, B):
    """Rows of B bytes, 16 and not: one lane a byte width where B allows,
    ABS and DELTA, the rest CONST."""
    rng = np.random.default_rng(B)
    entries, off, K = [], 0, 0
    for lane in range(tw.NUM_LANES):
        width = min(1 + lane % 8, B - off)
        if width <= 0:
            entries.append(tw.LaneCode(lane, tw.KIND_CONST, 0, 0, 1, lane - 9, -1))
            continue
        if lane % 2:
            entries.append(tw.LaneCode(lane, tw.KIND_DELTA, off, width, 7, 0, K))
            K += 1
        else:
            entries.append(tw.LaneCode(lane, tw.KIND_ABS, off, width, 1, 0, -1))
        off += width
    W, E = 5, 70
    slab, bases, n_events = _random_inputs(rng, W, E, B, K, [E, 69, 64, 33, 0])
    got = _host_decode(host_e, slab, bases, n_events, tuple(entries), offset=B % 5)
    np.testing.assert_array_equal(got, _jax_decode(slab, bases, n_events, tuple(entries)))


def test_wide_delta_lanes_wrap_as_jax(host_e):
    """Three 8-byte DELTA lanes of codes near the int64 limits, scales 1,
    3 and 2^33 + 1, and bases at the limits: the running sums and the
    products wrap, as JAX's int64 does."""
    entries, K = [], 0
    for lane in range(tw.NUM_LANES):
        if lane in (0, 3, 5):
            scale = {0: 1, 3: 3, 5: 2**33 + 1}[lane]
            entries.append(tw.LaneCode(lane, tw.KIND_DELTA, 8 * K, 8, scale, 0, K))
            K += 1
        else:
            entries.append(tw.LaneCode(lane, tw.KIND_CONST, 0, 0, 1, -lane, -1))
    rng = np.random.default_rng(5)
    W, E = 3, 40
    codes = rng.integers(2**62, 2**63 - 1, (W, E, K), dtype=np.int64)
    codes[:, ::3] = -codes[:, ::3] - 1
    slab = codes.view(np.uint8).reshape(W, E, 8 * K)
    bases = np.array([[2**63 - 1, -2**63, 2**62]] * W, dtype=np.int64)
    n_events = np.array([E, 33, 17], dtype=np.int32)
    want = _jax_decode(slab, bases, n_events, tuple(entries))
    assert (np.diff(want[0, :, 0]) != codes[0, 1:, 0]).sum() == 0  # the JAX sum wraps
    assert (want[0, :, 0] < 0).any() and (want[0, :, 0] > 0).any()
    np.testing.assert_array_equal(
        _host_decode(host_e, slab, bases, n_events, tuple(entries), offset=3), want)


def test_every_lane_const(host_e):
    """B = 0 (every lane CONST): no slab bytes to copy; padding rows still
    take the pad values."""
    entries = tuple(tw.LaneCode(lane, tw.KIND_CONST, 0, 0, 1, 1000 + lane, -1)
                    for lane in range(tw.NUM_LANES))
    W, E = 5, 34
    slab = np.zeros((W, E, 0), dtype=np.uint8)
    bases = np.zeros((W, 0), dtype=np.int64)
    n_events = np.array([0, 1, 33, 34, 12], dtype=np.int32)
    got = _host_decode(host_e, slab, bases, n_events, entries)
    np.testing.assert_array_equal(got, _jax_decode(slab, bases, n_events, entries))
