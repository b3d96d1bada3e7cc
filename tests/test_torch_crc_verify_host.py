"""Kernels C (csrc/crc32.cu) and D (csrc/verify.cu) compiled as host C++
(tests/torch_parity.py host_kernel), each block run through the kernel's
own schedule (crc_block, verify_block) on CPU tensors: every block of a
chosen grid, each step's threads in turn, a warp's lanes side by side at
C's shuffles (the stand-in's simulated warp), cp.async made at its wait. Held, exactly, to zlib.crc32 and the JAX
package's ops/crc.py crc32_rows, and to its ops/replay.py verify_rows. The
card's compile and launch are held by chip_smoke.py alone."""
import ctypes
import zlib

import numpy as np
import pytest
import torch

from cadence_tpu.core.checksum import DEFAULT_LAYOUT, PAD
from cadence_tpu.ops.crc import crc32_rows as j_crc32_rows
from cadence_tpu.ops.replay import verify_rows as j_verify_rows
from cadence_tpu.ops.state import widen_layout

#: H100's shared memory a block may opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin)
OPTIN = 232448
#: the payload's width, its even neighbour, the narrowest rows, and the
#: widest layout the ladder's rungs name (x8, kernel A's global route)
WIDTHS = (1, 2, 88, DEFAULT_LAYOUT.width, widen_layout(DEFAULT_LAYOUT, 8).width)
MASK = 0xFFFFFFFF

C_HARNESS = r"""
// A step of crc_block on the host: each thread in turn, or a warp's 32
// lanes side by side where the step shuffles.
struct HostStep {
  int nthreads;
  template <class F>
  void operator()(F fn, bool warp) const {
    if (warp)
      for (int w = 0; w < nthreads / 32; ++w)
        host_warp([&](int lane) {
          threadIdx.x = w * 32 + lane;
          fn(w * 32 + lane);
        });
    else
      for (int tid = 0; tid < nthreads; ++tid) {
        threadIdx.x = tid;
        fn(tid);
      }
  }
};

template <int P>
void run_crc(const CrcArgs& a, int blocks) {
  std::vector<uint64_t> smem((smem_bytes(a.width, a.tile_rows) + 7) / 8);
  host_pipes.clear();
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    std::fill(smem.begin(), smem.end(), 0xA5A5A5A5A5A5A5A5ull);  // what a block finds
    crc_block<P>(a, smem.data(), b, blocks, HostStep{C_ROWS * P});
  }
}

extern "C" int host_crc(const int64_t* rows, int64_t* out, int64_t W, int width, int S,
                        int tile_rows, int blocks) {
  std::vector<uint32_t> shift(size_t(S > 1 ? S - 1 : 0) * C_SHIFT_WORDS);
  combine_tables(width, S, shift.data());
  const CrcArgs a{rows, out, W, width, S, tile_rows, shift.data()};
  if (S < 1 || S > C_MAX_SPLIT || tile_rows % 2 || tile_rows > C_ROWS) return -1;
  if (S <= 1) run_crc<1>(a, blocks);
  else if (S <= 2) run_crc<2>(a, blocks);
  else if (S <= 4) run_crc<4>(a, blocks);
  else run_crc<8>(a, blocks);
  return 0;
}

extern "C" void host_shift(long long n, uint32_t* out) { shift_tables(n, out); }
extern "C" void host_combine(int width, int S, uint32_t* out) { combine_tables(width, S, out); }
extern "C" int host_tile_rows(int width, long long smem) { return tile_rows_for(width, smem); }
extern "C" int host_lanes(long long W, int sms) { return lanes_for(W, sms); }
extern "C" void host_segment(int width, int S, int s, int* out) {
  const Segment g = segment(width, S, s);
  out[0] = g.w0;
  out[1] = g.w1;
}
extern "C" int host_c_rows() { return C_ROWS; }
extern "C" int host_table_bytes() { return C_TABLE_U64 * 8; }
"""

D_HARNESS = r"""
// A step of verify_block on the host: each thread in turn.
struct HostStep {
  template <class F>
  void operator()(F fn) const {
    for (int tid = 0; tid < D_THREADS; ++tid) fn(tid);
  }
};

extern "C" void host_verify(const int64_t* rows, const int64_t* expected, const int32_t* branch,
                            const int32_t* expected_branch, uint8_t* out, int64_t W, int width,
                            int blocks) {
  const VerifyArgs a{rows, expected, branch, expected_branch, out, W, width,
                     reciprocal_of(width)};
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    uint8_t flag[D_ROWS];
    std::memset(flag, 0xA5, sizeof flag);  // what a block finds
    verify_block(a, flag, b, blocks, HostStep{});
  }
}

extern "C" int host_d_rows() { return D_ROWS; }
"""


@pytest.fixture(scope="module")
def host_c(tmp_path_factory):
    from tests.torch_parity import host_kernel

    lib = host_kernel(tmp_path_factory.mktemp("crc32"), "crc32.cu",
                      "// The kernel and its launcher", C_HARNESS, close="}  // namespace\n")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_crc.restype = I
    lib.host_crc.argtypes = [P, P, L, I, I, I, I]
    lib.host_shift.restype = None
    lib.host_shift.argtypes = [L, P]
    lib.host_combine.restype = None
    lib.host_combine.argtypes = [I, I, P]
    lib.host_tile_rows.argtypes = [I, L]
    lib.host_lanes.argtypes = [L, I]
    lib.host_segment.argtypes = [I, I, I, P]
    lib.host_segment.restype = None
    return lib


@pytest.fixture(scope="module")
def host_d(tmp_path_factory):
    from tests.torch_parity import host_kernel

    lib = host_kernel(tmp_path_factory.mktemp("verify"), "verify.cu",
                      "// The kernel and its launcher", D_HARNESS, close="}  // namespace\n")
    P = ctypes.c_void_p
    lib.host_verify.restype = None
    lib.host_verify.argtypes = [P, P, P, P, P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    return lib


def _rows(W, width, seed):
    """[W, width] int64 rows of random words, INT64_MIN, PAD, -1 and 0,
    row 0 all INT64_MIN and the last row all PAD."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, size=(W, width),
                        dtype=np.int64, endpoint=True)
    for value, share in ((PAD, 0.2), (-1, 0.2), (0, 0.1), (np.iinfo(np.int64).min, 0.05)):
        rows[rng.random((W, width)) < share] = value
    rows[0] = np.iinfo(np.int64).min
    if W > 1:
        rows[-1] = PAD
    return rows


def _zlib(rows):
    return np.array([zlib.crc32(r.astype("<i8").tobytes()) for r in rows], dtype=np.int64)


def _host_crc(lib, rows, S, blocks=1, tile_rows=None):
    W, width = rows.shape
    if tile_rows is None:
        tile_rows = lib.host_tile_rows(width, OPTIN)
    src = torch.from_numpy(np.ascontiguousarray(rows))
    out = torch.full((W,), -7, dtype=torch.int64)
    assert lib.host_crc(src.data_ptr(), out.data_ptr(), W, width, S, tile_rows, blocks) == 0
    return out.numpy()


def _apply(table, x):
    """A shift table set ([4 * 256] uint32) applied to a register."""
    return int(table[x & 255] ^ table[256 + ((x >> 8) & 255)] ^ table[512 + ((x >> 16) & 255)]
               ^ table[768 + (x >> 24)])


def _register(data: bytes, init: int) -> int:
    """The CRC register after `data` from register `init` (no final XOR)."""
    return zlib.crc32(data, init ^ MASK) ^ MASK


@pytest.mark.parametrize("n", [0, 1, 7, 8, 184, 712, 4744])
def test_shift_tables_equal_zlib(host_c, n):
    """The four tables that shift a register past n bytes give zlib's
    register after n zero bytes, for random registers and the bit basis."""
    table = np.zeros(4 * 256, dtype=np.uint32)
    host_c.host_shift(n, table.ctypes.data)
    rng = np.random.default_rng(n)
    regs = [1 << b for b in range(32)] + rng.integers(0, 1 << 32, 32).tolist() + [0, MASK]
    for x in regs:
        assert _apply(table, x) == _register(bytes(n), x), (n, x)


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("width", WIDTHS)
def test_combine_tables_join_zlib_segments(host_c, width, S):
    """A row cut into S segments: each segment's register (segment 0 from
    0xFFFFFFFF, the rest from 0) shifted by its table past the bytes after
    it, XOR-ed together, is zlib.crc32 of the whole row; the segments
    tile the row in order, S > width leaving empty ones."""
    table = np.zeros(max(S - 1, 1) * 1024, dtype=np.uint32)
    host_c.host_combine(width, S, table.ctypes.data)
    rows = _rows(3, width, 100 * width + S)
    seg = (ctypes.c_int * 2)()
    bounds = []
    for s in range(S):
        host_c.host_segment(width, S, s, seg)
        bounds.append((seg[0], seg[1]))
    assert bounds[0][0] == 0 and bounds[-1][1] == width
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    for row in rows:
        data = row.astype("<i8").tobytes()
        reg = 0
        for s, (w0, w1) in enumerate(bounds):
            r = _register(data[8 * w0:8 * w1], MASK if s == 0 else 0)
            reg ^= _apply(table[1024 * s:1024 * (s + 1)], r) if s < S - 1 else r
        assert reg ^ MASK == zlib.crc32(data)


@pytest.mark.parametrize("width", WIDTHS)
def test_tile_rows_and_strides(host_c, width):
    """Tiles are an even row count up to C_ROWS whose two stages and table
    fit the card's shared memory; a tile row's stride is odd (no two lanes
    of a half-warp on one bank pair)."""
    c_rows = host_c.host_c_rows()
    r = host_c.host_tile_rows(width, OPTIN)
    assert r % 2 == 0 and 2 <= r <= c_rows
    stride = width | 1
    assert stride % 2 == 1 and stride >= width
    table = host_c.host_table_bytes()
    assert table % (8 * 256 * 4) == 0
    assert table + 2 * r * stride * 8 <= OPTIN
    assert r == c_rows or table + 2 * (r + 2) * stride * 8 > OPTIN
    # 16 rows a half-warp reads, each its own word: 16 distinct 8-byte bank pairs
    assert len({(k * stride) % 16 for k in range(16)}) == 16


def test_lanes_for_fills_the_card(host_c):
    """At the launch shapes on 132 SMs: 4,096 rows take 8 lanes a row,
    16,384 and more take 4."""
    got = {W: host_c.host_lanes(W, 132) for W in (4096, 16384, 40960, 131072)}
    assert got == {4096: 8, 16384: 4, 40960: 4, 131072: 4}


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("width", WIDTHS)
def test_host_crc_every_split(host_c, width, S):
    """Each split of a row among 1 to 8 lanes (more lanes than words
    included), one tile plus one row: zlib.crc32 of every row."""
    W = host_c.host_tile_rows(width, OPTIN) + 1
    rows = _rows(W, width, 7 * width + S)
    assert np.array_equal(_host_crc(host_c, rows, S), _zlib(rows))


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("W", [1, 2, 7, 31, 32, 33, 5 * 32 + 7])
@pytest.mark.parametrize("width", [88, 89])
def test_host_crc_every_row_count(host_c, width, W, S, blocks):
    """1, 2 and an odd number of rows, one tile less one, one tile, one
    tile plus one and several tiles, over one block and over a grid of
    three that walks its tiles through both stages: zlib.crc32."""
    rows = _rows(W, width, W + width + S)
    assert np.array_equal(_host_crc(host_c, rows, S, blocks), _zlib(rows))


@pytest.mark.parametrize("width", WIDTHS)
def test_host_crc_equals_jax(host_c, width):
    """The JAX package's crc32_rows on the same rows (every split the
    launcher picks, and the widest), tiles of two rows over a grid of 3."""
    rows = _rows(45, width, width)
    want = np.asarray(j_crc32_rows(rows)).astype(np.int64)
    for S in (1, 2, 4, 8):
        assert np.array_equal(_host_crc(host_c, rows, S), want)
    assert np.array_equal(_host_crc(host_c, rows, 8, blocks=3, tile_rows=2), want)


def _host_verify(lib, rows, expected, branch, expected_branch, blocks=1):
    W, width = rows.shape
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (rows, expected, branch,
                                                           expected_branch)]
    out = torch.full((W,), 7, dtype=torch.uint8)
    lib.host_verify(*(x.data_ptr() for x in t), out.data_ptr(), W, width, blocks)
    return out.numpy().astype(bool)


def _jax_verify(rows, expected, branch, expected_branch):
    return np.asarray(j_verify_rows(rows, expected, branch, expected_branch)).astype(bool)


def _mismatch_cases(W, width, rng):
    """(name, altered rows, expected rows, expected branch) cases: none, a
    row's last word only, its first word only, the branch only, two
    adjacent rows at their shared boundary words, and random words."""
    rows = _rows(W, width, W * width)
    branch = rng.integers(0, 4, W).astype(np.int32)
    cases = [("none", rows.copy(), branch.copy())]
    r = W // 2
    for name, col in (("last word", width - 1), ("first word", 0)):
        exp = rows.copy()
        exp[r, col] ^= 1
        cases.append((name, exp, branch.copy()))
    eb = branch.copy()
    eb[r] += 1
    cases.append(("branch", rows.copy(), eb))
    if W > 1:
        exp = rows.copy()
        exp[0, width - 1] += 1    # row 0's last word and row 1's first share a
        exp[1, 0] -= 1            # 16-byte unit where width is odd
        cases.append(("adjacent rows", exp, branch.copy()))
        exp = rows.copy()
        exp[1, 0] -= 1            # the unit's second word alone: row 0 stays clean
        cases.append(("next row's first word", exp, branch.copy()))
    exp = rows.copy()
    hit = rng.random((W, width)) < 0.02
    exp[hit] += 1
    eb = branch.copy()
    eb[rng.random(W) < 0.1] -= 1
    cases.append(("random", exp, eb))
    return rows, branch, cases


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("W", [1, 2, 7, 8, 9, 45])
@pytest.mark.parametrize("width", WIDTHS)
def test_host_verify_equals_jax(host_d, width, W, blocks):
    """Every mismatch case at 1, 2 and an odd number of rows, one tile less
    one, one tile, one tile plus one and several tiles, over one block and
    a grid of three: the JAX package's verify_rows, bit for bit, and the
    flagged rows exactly those altered."""
    assert host_d.host_d_rows() == 8
    rng = np.random.default_rng(W * 1000 + width)
    rows, branch, cases = _mismatch_cases(W, width, rng)
    for name, exp, eb in cases:
        got = _host_verify(host_d, rows, exp, branch, eb, blocks)
        want = _jax_verify(rows, exp, branch, eb)
        assert np.array_equal(got, want), (name, np.nonzero(got != want))
        altered = (rows != exp).any(1) | (branch != eb)
        assert np.array_equal(got, altered), name


def test_wrappers_take_the_kernel_or_raise():
    """Off the CPU the wrappers launch kernels C and D or raise: a meta
    tensor is refused, never hashed or compared by the plain version; a
    base off a 16-byte boundary (a slice at an odd row of 89 words) is
    handed to the kernel as an aligned copy on its own device."""
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.ops.crc import crc32_rows
    from cadence_tpu_torch.ops.replay import verify_launch

    meta = torch.empty((4, DEFAULT_LAYOUT.width), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        crc32_rows(meta)
    rows = torch.zeros((4, DEFAULT_LAYOUT.width), dtype=torch.int64)
    br = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        verify_launch(rows, rows, br, br)
    rows = torch.arange(4 * DEFAULT_LAYOUT.width, dtype=torch.int64).view(4, -1)
    assert _build.aligned(rows) is rows
    odd = rows[1:]
    assert odd.data_ptr() % 16
    copy = _build.aligned(odd)
    assert copy.data_ptr() % 16 == 0 and copy.device == odd.device
    assert torch.equal(copy, odd)
    even = rows[2:]
    assert _build.aligned(even) is even


def test_launcher_counts_launches_by_shape():
    """A launch counts once in _build.launches and once under (kernel, the
    shape of its first tensor argument) in _build.launch_shapes, only when
    it runs and its entry point returns success; reset_launches clears
    both."""
    from cadence_tpu_torch.ops import _build

    rows = torch.zeros((6, DEFAULT_LAYOUT.width), dtype=torch.int64)
    calls = []
    ok = _build.launcher("crc32", lambda *a: calls.append(a) or 0, 7, rows, rows.shape[0])
    bad = _build.launcher("crc32", lambda *a: 1, rows)
    _build.reset_launches()
    assert _build.launches["crc32"] == 0 and not _build.launch_shapes
    ok()
    ok()
    with pytest.raises(RuntimeError, match="crc32"):
        bad()
    assert calls == [(7, rows.data_ptr(), 6)] * 2
    assert _build.launches["crc32"] == 2
    assert _build.launch_shapes == {("crc32", (6, DEFAULT_LAYOUT.width)): 2}
    _build.reset_launches()
    assert _build.launches["crc32"] == 0 and not _build.launch_shapes
