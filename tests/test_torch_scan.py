"""The port's ops/scan.py against the JAX package's: the host half
(plan_leaf_int, compile_plan) and the plain versions of kernels J, K and
L (scan_count, scan_bitmap, scan_topk, scan_apply on the CPU) against
build_count, build_bitmap, build_topk and build_apply, on columns made
from seeds with numpy that hold NULL_ID, NaN, -0.0, +-inf, INT64_MIN and
INT64_MAX. Every output is an integer, a bool or a copied float:
compared exactly."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadence_tpu.engine import visibility_device as jvd
from cadence_tpu.engine.persistence import VisibilityRecord as JRecord
from cadence_tpu.engine.visibility_query import parse_query as jparse
from cadence_tpu.ops import scan as js
from cadence_tpu_torch.engine import visibility_device as tvd
from cadence_tpu_torch.engine.persistence import VisibilityRecord as TRecord
from cadence_tpu_torch.engine.visibility_query import parse_query as tparse
from cadence_tpu_torch.ops import scan as ts

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
OPS = ("=", "!=", "<", "<=", ">", ">=")
N = 256

LEAF_VALUES = [0, 5, -7, I64_MIN, I64_MAX, I64_MAX + 1, I64_MIN - 1, 1 << 70, -(1 << 70),
               5.0, -0.0, 2.5, -2.5, 1e300, -1e300, 9.3e18, -9.3e18, 9.2233720368547758e18,
               float("inf"), float("-inf"), float("nan"), "s", True, None]


@pytest.mark.parametrize("value", LEAF_VALUES, ids=repr)
def test_plan_leaf_int_as_jax(value):
    for op in OPS:
        assert ts.plan_leaf_int(op, value) == js.plan_leaf_int(op, value), (op, value)


def test_codes_as_jax():
    names = [n for n in dir(js) if n.startswith(("OP_", "COL_"))] + ["NULL_ID"]
    assert {n: getattr(ts, n) for n in names} == {n: getattr(js, n) for n in names}
    for n in (1, 63, 64, 65, 1000, 4097):
        assert ts.pow2_bucket(n) == js.pow2_bucket(n)
        assert ts.pow2_bucket(n, floor=8) == js.pow2_bucket(n, floor=8)


# --- compile_plan on random ASTs through both views' binders ----------------

_FIELDS = ("WorkflowID", "WorkflowType", "RunID", "CloseStatus", "StartTime", "CloseTime",
           "Num", "Str", "Absent")


def _rand_value(rng, field):
    r = rng.random()
    if field == "WorkflowType" and r < 0.5:
        return f"'type-{rng.randrange(6)}'"
    if field == "Str" and r < 0.6:
        return f"'v{rng.randrange(8)}'"
    if r < 0.2:
        return f"'s{rng.randrange(4)}'"
    if r < 0.5:
        return str(round(rng.uniform(-3, 12), 2))
    if r < 0.6:
        return str(rng.choice([2 ** 62, -(2 ** 62), 10 ** 20, 2 ** 53 + 1]))
    return str(rng.randrange(-5, 15))


def _rand_query(rng, depth=3):
    if depth <= 0 or rng.random() < 0.4:
        field = rng.choice(_FIELDS)
        op = rng.choice(OPS) if field not in ("WorkflowID", "RunID", "WorkflowType") \
            else rng.choice(("=", "!="))
        return f"{field} {op} {_rand_value(rng, field)}"
    q = f"{_rand_query(rng, depth - 1)} {rng.choice(('AND', 'OR'))} {_rand_query(rng, depth - 1)}"
    return f"({q})" if rng.random() < 0.4 else q


def _views(rng, n=40):
    """A JAX view and a port view (on the CPU) whose host mirrors hold the
    same n records; only their binders are used."""
    jv, tv = jvd.DeviceVisibilityView(), tvd.DeviceVisibilityView(device="cpu")
    for i in range(n):
        attrs = {}
        if rng.random() < 0.6:
            attrs["Num"] = rng.randrange(-5, 15)
        if rng.random() < 0.6:
            attrs["Str"] = f"v{rng.randrange(6)}"
        fields = ("d", f"wf-{i}", f"r-{i}", f"type-{rng.randrange(5)}", rng.randrange(50))
        for view, rec_cls in ((jv, JRecord), (tv, TRecord)):
            rec = rec_cls(*fields, search_attrs=dict(attrs))
            view._apply_upsert((i + 1, "up", (rec.domain_id, rec.workflow_id, rec.run_id),
                                rec.workflow_type, int(rec.close_status),
                                int(rec.start_time), int(rec.close_time),
                                dict(rec.search_attrs)))
    return jv, tv


@pytest.mark.parametrize("seed", [3, 17])
def test_compile_plan_as_jax(seed):
    rng = random.Random(seed)
    jv, tv = _views(rng)
    compiled = 0
    for _ in range(60):
        q = _rand_query(rng)
        try:
            jparse(q)
        except Exception:  # an unknown CloseStatus name: neither parser takes it
            with pytest.raises(Exception):
                tparse(q)
            continue
        outcome = []
        for view, scan, parse in ((jv, js, jparse), (tv, ts, tparse)):
            try:
                node, _ = parse(q)
                plan = scan.compile_plan(view._scoped(node, "d"), view._binder())
                outcome.append((plan.signature, plan.iparams.tolist(), plan.fparams.tobytes()))
            except scan.UnsupportedPredicate as exc:
                outcome.append(("unsupported", exc.reason))
        assert outcome[0] == outcome[1], q
        compiled += outcome[1][0] != "unsupported"
    assert compiled >= 30


def test_deep_nesting_keeps_the_stack_shallow():
    """A right-deep chain of 200 parenthesised leaves needs a stack of 201
    in plain postfix order; the program runs the deeper child first, so it
    needs 2, and counts as the JAX package's tree does."""
    q = "StartTime > 0"
    for i in range(1, 200):
        q = f"StartTime > {i} {'AND' if i % 2 else 'OR'} ({q})"
    rng = random.Random(1)
    jv, tv = _views(rng)
    plan = ts.compile_plan(tparse(q)[0], tv._binder())
    words, depth = ts.program(plan)
    assert len(words) == 399 and depth == 2
    cols, valid = _columns(np.random.default_rng(1), plan.slots, {s: "i64" for s in plan.slots})
    jplan = js.compile_plan(jparse(q)[0], jv._binder())
    assert jplan.signature == plan.signature
    want = js.build_count(jplan)(tuple(jnp.asarray(c) for c in cols), jnp.asarray(valid),
                                 jnp.asarray(jplan.iparams), jnp.asarray(jplan.fparams))
    got = ts.scan_count(plan, [torch.from_numpy(c) for c in cols], torch.from_numpy(valid))
    assert int(got) == int(want)


def test_program_past_the_stack_is_unsupported(monkeypatch):
    plan = ts.ScanPlan(("and", 0, ("or", 1, 2)), ((ts.COL_I64, ts.OP_GT, 0),) * 3, ("c",),
                       np.zeros(3, np.int64), np.zeros(3))
    assert ts.program(plan)[1] == 2
    monkeypatch.setattr(ts, "MAX_STACK", 1)
    with pytest.raises(ts.UnsupportedPredicate) as exc:
        ts.program(plan)
    assert exc.value.reason == "predicate"


# --- the plain versions of kernels J, K and L against build_* ---------------

def _columns(rng, slots, kinds, n=N):
    """One column per slot (int64 ids with NULL_ID, int64 with the int64
    edges, or float64 with NaN, -0.0 and +-inf) and a valid mask."""
    cols = []
    for s in slots:
        kind = kinds[s]
        if kind == "f64":
            c = rng.choice([0.0, -0.0, 1.5, -2.0, 3.0, 7.25, np.nan, np.inf, -np.inf, 1e300], n)
        elif kind == "id":
            c = rng.choice([-1, 0, 1, 2, 3, 4], n).astype(np.int64)
        else:
            c = rng.choice(np.array([I64_MIN, I64_MAX, I64_MIN + 1, -1, 0, 1, 5, 7, 1000],
                                    dtype=np.int64), n)
        cols.append(np.ascontiguousarray(c))
    return cols, rng.random(n) < 0.8


_KIND_OPS = {"id": (js.OP_EQ, js.OP_NE, js.OP_PRESENT),
             "i64": (js.OP_EQ, js.OP_NE, js.OP_LT, js.OP_LE, js.OP_GT, js.OP_GE),
             "f64": (js.OP_EQ, js.OP_NE, js.OP_LT, js.OP_LE, js.OP_GT, js.OP_GE, js.OP_PRESENT)}
_PARAMS = {"id": [-1, 0, 2, 4, 9], "i64": [I64_MIN, I64_MAX, -1, 0, 5, 1000],
           "f64": [0.0, -0.0, 1.5, 3.0, np.inf, -np.inf, np.nan, 7.25]}


def _rand_plan(rng, n_cols=4, n_leaves=6):
    """A random plan over n_cols columns of random kinds: constant leaves,
    every op of each kind, and/or trees of random shape."""
    kinds = {f"c{i}": str(rng.choice(["id", "i64", "f64"])) for i in range(n_cols)}
    slots = tuple(kinds)
    leaves, ip, fp = [], [], []
    for _ in range(n_leaves):
        slot = int(rng.integers(n_cols))
        kind = kinds[slots[slot]]
        op = int(rng.choice(_KIND_OPS[kind])) if rng.random() > 0.15 \
            else int(rng.choice([js.OP_FALSE, js.OP_TRUE]))
        leaves.append((kind, op, slot))
        p = rng.choice(_PARAMS[kind])
        ip.append(int(p) if kind != "f64" else 0)
        fp.append(float(p) if kind == "f64" else 0.0)
    trees = list(range(n_leaves))
    while len(trees) > 1:
        i = int(rng.integers(len(trees) - 1))
        trees[i:i + 2] = [(str(rng.choice(["and", "or"])), trees[i], trees[i + 1])]
    args = (trees[0], tuple(leaves), slots, np.asarray(ip, np.int64), np.asarray(fp, np.float64))
    return ts.ScanPlan(*args), js.ScanPlan(*args), kinds


def _both(plan, jplan, kinds, rng, n=N):
    cols, valid = _columns(rng, plan.slots, kinds, n)
    start = rng.choice(np.array([I64_MIN, I64_MAX, -3, 0, 5, 6, 1 << 40], dtype=np.int64), n)
    jargs = (tuple(jnp.asarray(c) for c in cols), jnp.asarray(valid))
    targs = ([torch.from_numpy(c) for c in cols], torch.from_numpy(valid))
    return jargs, targs, start


@pytest.mark.parametrize("seed", range(6))
def test_count_bitmap_topk_as_jax(seed):
    rng = np.random.default_rng(seed)
    plan, jplan, kinds = _rand_plan(rng, n_leaves=2 + seed)
    (jcols, jvalid), (tcols, tvalid), start = _both(plan, jplan, kinds, rng)
    ip, fp = jnp.asarray(jplan.iparams), jnp.asarray(jplan.fparams)
    want = int(js.build_count(jplan)(jcols, jvalid, ip, fp))
    got = ts.scan_count(plan, tcols, tvalid)
    assert got.dtype == torch.int64 and int(got) == want
    jbits, jc = js.build_bitmap(jplan)(jcols, jvalid, ip, fp)
    bits, c = ts.scan_bitmap(plan, tcols, tvalid)
    assert bits.dtype == torch.uint8 and np.array_equal(bits.numpy(), np.asarray(jbits))
    assert int(c) == int(jc) == want
    for k in (64, 128):
        jids, jc = js.build_topk(jplan, k)(jcols, jvalid, jnp.asarray(start), ip, fp)
        ids, c = ts.scan_topk(plan, k, tcols, tvalid, torch.from_numpy(start))
        assert ids.dtype == torch.int64 and np.array_equal(ids.numpy(), np.asarray(jids)), k
        assert int(c) == int(jc) == want


@pytest.mark.parametrize("matches", [0, 5, 100])
def test_topk_count_zero_and_below_k(matches):
    """count = 0 and count < k: the tail holds non-matching rows in the
    same (-start, row) order as the JAX package's."""
    rng = np.random.default_rng(matches)
    col = np.zeros(N, np.int64)
    col[rng.choice(N, matches, replace=False)] = 1
    start = rng.choice(np.array([I64_MIN, 3, 3, 9, -9], np.int64), N)
    valid = np.ones(N, bool)
    plan = ts.ScanPlan(0, ((ts.COL_I64, ts.OP_EQ, 0),), ("c",), np.ones(1, np.int64), np.zeros(1))
    jplan = js.ScanPlan(0, ((js.COL_I64, js.OP_EQ, 0),), ("c",), np.ones(1, np.int64),
                        np.zeros(1))
    for k in (64, 128):
        jids, jc = js.build_topk(jplan, k)((jnp.asarray(col),), jnp.asarray(valid),
                                          jnp.asarray(start), jnp.asarray(jplan.iparams),
                                          jnp.asarray(jplan.fparams))
        ids, c = ts.scan_topk(plan, k, [torch.from_numpy(col)], torch.from_numpy(valid),
                              torch.from_numpy(start))
        assert np.array_equal(ids.numpy(), np.asarray(jids)) and int(c) == int(jc) == matches


def test_topk_int64_min_sorts_first():
    """-start wraps: a matching row with start INT64_MIN sorts first."""
    start = torch.tensor([I64_MIN, 5, 0, -3], dtype=torch.int64)
    mask = torch.tensor([True, True, False, True])
    assert ts.topk_order_plain(mask, start).tolist() == [0, 1, 3, 2]
    want = jnp.lexsort((jnp.arange(4), -jnp.asarray(start.numpy()), ~jnp.asarray(mask.numpy())))
    assert np.asarray(want).tolist() == [0, 1, 3, 2]


def test_apply_negative_index_wraps_once():
    """.at[idx].set(mode="drop"): -1 writes row 7, 8 and -9 are dropped."""
    col = torch.arange(8, dtype=torch.int64)
    idx = torch.tensor([-1, 8, 2, -9], dtype=torch.int64)
    ts.scan_apply([col], idx, [torch.tensor([70, 80, 20, 90], dtype=torch.int64)])
    want = jnp.arange(8).at[jnp.asarray(idx.numpy())].set(jnp.asarray([70, 80, 20, 90]),
                                                          mode="drop")
    assert col.tolist() == np.asarray(want).tolist() == [0, 1, 20, 3, 4, 5, 6, 70]


@pytest.mark.parametrize("bucket", [64, 128])
def test_apply_as_jax(bucket):
    """A padded delta batch (distinct rows, a few negative, pads = N) into
    int64, float64 and bool columns, as build_apply writes it."""
    rng = np.random.default_rng(bucket)
    n_rows = bucket - 9
    rows = rng.choice(N, n_rows, replace=False).astype(np.int64)
    rows[:5] -= N  # the same rows, written as negative indices
    idx = np.full(bucket, N, np.int64)
    idx[:n_rows] = rows
    cols = [rng.integers(-5, 5, N).astype(np.int64), rng.random(N), rng.random(N) < 0.5]
    vals = [rng.integers(-5, 5, bucket).astype(np.int64),
            rng.choice([np.nan, -0.0, np.inf, 2.5], bucket), rng.random(bucket) < 0.5]
    want = js.build_apply(tuple(str(c.dtype) for c in cols))(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(idx), tuple(jnp.asarray(v) for v in vals))
    got = ts.scan_apply([torch.from_numpy(c.copy()) for c in cols], torch.from_numpy(idx),
                        [torch.from_numpy(v) for v in vals])
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


# --- kernel K's select route: its plain twin against the lexsort and JAX ---

_BASE = 1_700_000_000_000_000_000


def _topk_case(name, n):
    """(mask, start) of one shape kernel K's select must meet: start times
    sharing their high bits, 16 start times (visibility_path's ties
    domain), INT64_MIN and the other edges, no match, fewer matches than a
    page, one start time for every row, keys over the whole int64 range."""
    rng = np.random.default_rng(_TOPK_CASES.index(name))
    mask = rng.random(n) < 0.5
    if name == "shared_high_bits":
        start = _BASE + rng.integers(0, 1 << 20, n)
    elif name == "ties_16":
        start = _BASE + (np.arange(n) % 16) * 1000
    elif name == "int64_min":
        start = rng.choice(np.array([I64_MIN, I64_MIN + 1, -1, 0, 5, I64_MAX]), n)
    elif name == "count_0":
        mask[:] = False
        start = _BASE + rng.integers(0, 100, n)
    elif name == "below_k":
        mask[:] = False
        mask[rng.choice(n, 7, replace=False)] = True
        start = _BASE + rng.integers(0, 50, n)
    elif name == "all_equal":
        start = np.full(n, _BASE)
    else:  # "full_range"
        start = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)
    return mask, np.asarray(start, dtype=np.int64)


_TOPK_CASES = ("shared_high_bits", "ties_16", "int64_min", "count_0", "below_k", "all_equal",
               "full_range")


@pytest.mark.parametrize("small", [False, True], ids=["kernel_constants", "many_passes"])
@pytest.mark.parametrize("case", _TOPK_CASES)
def test_topk_select_as_jax(case, small):
    """The select-then-sort stages (the first differing bit, digit
    histograms, the boundary bucket, the candidates, their sort) give the
    first k of topk_order_plain and of JAX build_topk for k = 1, a page
    plus one, a page, and N. `many_passes` shrinks the digit to 3 bits and
    the bucket cap to 8, so ties split by row and each select takes passes."""
    n = 512
    mask, start = _topk_case(case, n)
    plan = ts.ScanPlan(0, ((ts.COL_ID, ts.OP_PRESENT, 0),), ("m",), np.zeros(1, np.int64),
                       np.zeros(1))
    jplan = js.ScanPlan(0, ((js.COL_ID, js.OP_PRESENT, 0),), ("m",), np.zeros(1, np.int64),
                        np.zeros(1))
    col = np.where(mask, 1, -1).astype(np.int64)
    valid = np.ones(n, bool)
    jids, jc = js.build_topk(jplan, n)((jnp.asarray(col),), jnp.asarray(valid),
                                       jnp.asarray(start), jnp.asarray(jplan.iparams),
                                       jnp.asarray(jplan.fparams))
    order = ts.topk_order_plain(torch.from_numpy(mask), torch.from_numpy(start))
    assert np.array_equal(order.numpy(), np.asarray(jids)) and int(jc) == int(mask.sum())
    kw = {"digit": 3, "cap": 8} if small else {}
    for k in (1, 101, 128, n):
        got = ts.topk_select_plain(torch.from_numpy(mask), torch.from_numpy(start), k, **kw)
        assert np.array_equal(got.numpy(), np.asarray(jids)[:k]), k
        ids, c = ts.scan_topk(plan, k, [torch.from_numpy(col)], torch.from_numpy(valid),
                              torch.from_numpy(start))
        assert torch.equal(ids, got) and int(c) == int(mask.sum())


def test_topk_route_by_k():
    """Up to TOPK_SELECT_MAX the select route; above it the full sort,
    which takes a power-of-two row count."""
    assert ts.topk_route(1 << 24, 1) == ts.topk_route(1 << 24, 4096) == "select"
    assert ts.topk_route(1 << 24, ts.TOPK_SELECT_MAX) == "select"
    assert ts.topk_route(1 << 24, ts.TOPK_SELECT_MAX + 1) == "sort"
    assert ts.TOPK_SELECT_MAX == ts.TOPK_SORT_MAX - ts.TOPK_CAP


def test_topk_select_at_the_route_seam():
    """k = TOPK_SELECT_MAX (the select's largest: at most k - 1 + TOPK_CAP
    candidates, the sort's capacity) and k just above it, on 16,384 rows of
    16 start times, against the JAX order."""
    n = 16384
    mask, start = _topk_case("ties_16", n)
    want = np.asarray(jnp.lexsort((jnp.arange(n), -jnp.asarray(start), ~jnp.asarray(mask))))
    m, st = torch.from_numpy(mask), torch.from_numpy(start)
    for k in (ts.TOPK_SELECT_MAX, ts.TOPK_SELECT_MAX + 1, n):
        assert np.array_equal(ts.topk_select_plain(m, st, k).numpy(), want[:k]), k


def test_topk_constants_are_the_kernels():
    """The twin's digit, cap and sort capacity are csrc/scan.cu's."""
    import pathlib
    import re

    src = (pathlib.Path(ts.__file__).parents[1] / "csrc" / "scan.cu").read_text()
    consts = dict(re.findall(r"constexpr (?:int|int64_t) (K_\w+) = (\d+);", src))
    assert int(consts["K_DIGIT"]) == ts.TOPK_DIGIT
    assert int(consts["K_CAP"]) == ts.TOPK_CAP
    assert int(consts["K_SORT_MAX"]) == ts.TOPK_SORT_MAX


# --- kernels J and L compiled for the host: csrc/scan.cu's phases (a lane's
# rows, a warp's words and count, a block's partial, the last block's sum;
# L's (column, row) unit) run lane by lane, the warp's ballot made here, on
# CPU tensors. The card's compile and launch are held by chip_smoke.py alone.

JL_HARNESS = r"""
template <class Plan>
long long run_mask(const Plan& P, const uint8_t* valid, int64_t N, int max_blocks,
                   uint32_t* bitmap, MaskScratch* s, unsigned long long* count, int reverse) {
  const int g = j_grid(N, max_blocks);
  int last = -1;
  for (int k = 0; k < g; ++k) {
    const int b = reverse ? g - 1 - k : k;
    unsigned long long block = 0;
    for (int w = 0; w < J_WARPS; ++w)
      for (int64_t tile = first_tile(b, w); tile * J_TILE < N; tile += tile_step(g)) {
        const int64_t t0 = tile * J_TILE;
        bool m[32][J_ROWS];
        for (int lane = 0; lane < 32; ++lane) lane_rows(P, valid, N, t0 + lane, m[lane]);
        unsigned bits[J_ROWS] = {};
        for (int j = 0; j < J_ROWS; ++j)
          for (int lane = 0; lane < 32; ++lane) bits[j] |= unsigned(m[lane][j]) << lane;
        unsigned c = 0;
        for (int lane = 0; lane < 32; ++lane) c = tile_out(bits, bitmap, t0, N, lane);
        block += c;
      }
    unsigned long long total = 0;
    if (block_partial(s, g, block, &total)) {
      if (last >= 0) return -2;  // two blocks took the last ticket
      last_block_out(s, total, count);
      last = b;
    }
  }
  return last < 0 ? -1 : g;
}

extern "C" long long host_mask(const void* plan, const int64_t* table, int entries, int n_ins,
                               const uint8_t* valid, int64_t N, int max_blocks, uint32_t* bitmap,
                               void* scratch, unsigned long long* count, int reverse) {
  MaskScratch* s = static_cast<MaskScratch*>(scratch);
  if (plan != nullptr)
    return run_mask(*static_cast<const ValuePlan*>(plan), valid, N, max_blocks, bitmap, s, count,
                    reverse);
  return run_mask(TablePlan{table, entries, n_ins}, valid, N, max_blocks, bitmap, s, count,
                  reverse);
}

extern "C" void host_rows(const void* plan, const int64_t* table, int entries, int n_ins,
                          const uint8_t* valid, int64_t N, uint8_t* mask) {
  for (int64_t row = 0; row < N; ++row)
    mask[row] = valid[row] && (plan != nullptr
                                   ? eval_row(*static_cast<const ValuePlan*>(plan), row)
                                   : eval_row(TablePlan{table, entries, n_ins}, row));
}

extern "C" void host_apply(const int64_t* table, int C, const uint8_t* packed, int64_t B,
                           int64_t N) {
  const int64_t bx = (B + L_THREADS - 1) / L_THREADS;
  for (int c = 0; c < C; ++c)
    for (int64_t x = 0; x < bx; ++x)
      for (int t = 0; t < L_THREADS; ++t) apply_unit(table, C, packed, B, N, c, x * L_THREADS + t);
}

extern "C" void host_sizes(long long* out) {
  out[0] = sizeof(ValuePlan);
  out[1] = sizeof(MaskScratch);
}
"""


@pytest.fixture(scope="module")
def host_jl(tmp_path_factory):
    import ctypes

    from tests.torch_parity import host_kernel

    lib = host_kernel(tmp_path_factory.mktemp("scan"), "scan.cu",
                      "// The kernels and their launchers", JL_HARNESS, close="}  // namespace\n")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.host_mask.restype = ctypes.c_longlong
    lib.host_mask.argtypes = [P, P, I, I, P, L, I, P, P, P, I]
    lib.host_rows.restype = None
    lib.host_rows.argtypes = [P, P, I, I, P, L, P]
    lib.host_apply.restype = None
    lib.host_apply.argtypes = [P, I, P, L, L]
    lib.host_sizes.argtypes = [P]
    sizes = (ctypes.c_longlong * 2)()
    lib.host_sizes(sizes)
    # a ValuePlan of another layout would hand the kernel wild pointers
    assert sizes[0] == ctypes.sizeof(ts.ValuePlan), "ops/scan.py ValuePlan is not scan.cu's"
    return lib


def _host_plan(plan, cols, route):
    """(the plan arguments of host_mask and host_rows by `route`, what they
    point into)."""
    import ctypes

    entries, ins = ts.decode_plan(plan, cols)
    if route == "value":
        vp = ts.value_plan(entries, ins)
        return (ctypes.addressof(vp), None, 0, 0), vp
    table = torch.tensor(ts.table_plan(entries, ins), dtype=torch.int64)
    return (None, table.data_ptr(), len(entries), len(ins)), table


def _host_mask(lib, plan, cols, valid, route, max_blocks, scratch=None, reverse=False):
    """Kernel J compiled for the host on CPU tensors, by `route`: (bitmap,
    count, grid, the scratch word after the launch)."""
    n = valid.shape[0]
    bits = torch.full((n // 8,), 0xA5, dtype=torch.uint8)  # every byte must be written
    count = torch.full((), -7, dtype=torch.int64)
    if scratch is None:
        scratch = torch.zeros(ts.MASK_SCRATCH_BYTES, dtype=torch.uint8)
    args, _kept = _host_plan(plan, cols, route)
    grid = lib.host_mask(*args, valid.data_ptr(), n, max_blocks, bits.data_ptr(),
                         scratch.data_ptr(), count.data_ptr(), int(reverse))
    assert grid > 0, grid
    return bits, int(count), grid, int(scratch.view(torch.int64)[0])


def _leaf(kind, op, slot, param=0):
    ip = int(param) if kind != "f64" else 0
    fp = float(param) if kind == "f64" else 0.0
    return (kind, op, slot), ip, fp


def _chain(n, ops):
    """An and/or tree over leaves 0..n-1, nested n - 1 deep (each node's
    right child the next leaf), its ops cycling through `ops`."""
    tree = 0
    for i in range(1, n):
        tree = (ops[i % len(ops)], tree, i)
    return tree


def _named_plan(name):
    """(ScanPlan, JAX ScanPlan, column kinds) of one of the plans kernel J
    must meet: id EQ/NE/PRESENT against NULL_ID, every i64 op at INT64_MIN
    and INT64_MAX, f64 ops against NaN, +-inf and -0.0, the constants, a
    chain nested 10 deep, and 13 random leaves."""
    if name == "leaves_13":
        plan, jplan, kinds = _rand_plan(np.random.default_rng(13), n_cols=5, n_leaves=13)
        return plan, jplan, kinds
    if name == "id_null":
        kinds = {"a": "id", "b": "id"}
        leaves = [_leaf("id", js.OP_EQ, 0, -1), _leaf("id", js.OP_NE, 1, -1),
                  _leaf("id", js.OP_PRESENT, 0), _leaf("id", js.OP_NE, 0, 2),
                  _leaf("id", js.OP_EQ, 1, 3)]
        tree = ("or", ("and", 1, 2), ("or", 0, ("and", 3, 4)))
    elif name == "i64_edges":
        kinds = {"t": "i64"}
        ops = (js.OP_EQ, js.OP_NE, js.OP_LT, js.OP_LE, js.OP_GT, js.OP_GE)
        leaves = [_leaf("i64", op, 0, p) for op in ops for p in (I64_MIN, I64_MAX)]
        tree = _chain(len(leaves), ("or", "and"))
    elif name == "f64_specials":
        kinds = {"f": "f64", "g": "f64"}
        ops = (js.OP_EQ, js.OP_NE, js.OP_LT, js.OP_LE, js.OP_GT, js.OP_GE, js.OP_PRESENT)
        leaves = [_leaf("f64", op, i % 2, p) for i, (op, p) in enumerate(
            (op, p) for op in ops for p in (np.nan, np.inf, -np.inf, -0.0))]
        tree = _chain(len(leaves), ("or", "or", "and"))
    elif name == "constants":
        kinds = {"t": "i64", "a": "id"}
        leaves = [_leaf("i64", js.OP_TRUE, 0), _leaf("i64", js.OP_GT, 0, 0),
                  _leaf("id", js.OP_FALSE, 1), _leaf("id", js.OP_PRESENT, 1),
                  _leaf("i64", js.OP_FALSE, 0)]
        tree = ("or", ("and", 0, 1), ("and", ("or", 2, 3), ("or", 4, 0)))
    else:  # "nested_10"
        kinds = {"t": "i64", "f": "f64", "a": "id"}
        leaves = [_leaf("i64", js.OP_GE, 0, 5), _leaf("f64", js.OP_LT, 1, 1.5),
                  _leaf("id", js.OP_NE, 2, 1), _leaf("i64", js.OP_LT, 0, 1000),
                  _leaf("f64", js.OP_PRESENT, 1), _leaf("id", js.OP_EQ, 2, 4),
                  _leaf("i64", js.OP_NE, 0, -1), _leaf("f64", js.OP_GE, 1, -0.0),
                  _leaf("id", js.OP_PRESENT, 2), _leaf("i64", js.OP_LE, 0, 7),
                  _leaf("f64", js.OP_NE, 1, 3.0)]
        tree = _chain(len(leaves), ("and", "or", "or"))
    args = (tree, tuple(lf for lf, _, _ in leaves), tuple(kinds),
            np.asarray([ip for _, ip, _ in leaves], np.int64),
            np.asarray([fp for _, _, fp in leaves], np.float64))
    return ts.ScanPlan(*args), js.ScanPlan(*args), kinds


_MASK_PLANS = ("id_null", "i64_edges", "f64_specials", "constants", "nested_10", "leaves_13")
#: N: one tile's worth, a few blocks, and several blocks whose last tile is
#: partial (the rows past N masked off)
_MASK_NS = (64, 4096, (1 << 16) + 64)
_JAX_MASKS: dict = {}


def _mask_case(name, n):
    """(plan, torch columns, valid, JAX bitmap, JAX count) for one plan at n
    rows; the JAX side is made once a module."""
    plan, jplan, kinds = _named_plan(name)
    cols, valid = _columns(np.random.default_rng(n + _MASK_PLANS.index(name)), plan.slots,
                           kinds, n)
    if (name, n) not in _JAX_MASKS:
        jargs = (tuple(jnp.asarray(c) for c in cols), jnp.asarray(valid),
                 jnp.asarray(jplan.iparams), jnp.asarray(jplan.fparams))
        jbits, jc = js.build_bitmap(jplan)(*jargs)
        _JAX_MASKS[(name, n)] = (np.asarray(jbits), int(jc))
    return (plan, [torch.from_numpy(c) for c in cols], torch.from_numpy(valid)) \
        + _JAX_MASKS[(name, n)]


@pytest.mark.parametrize("route", ["value", "table"])
@pytest.mark.parametrize("n", _MASK_NS)
@pytest.mark.parametrize("name", _MASK_PLANS)
def test_host_mask_as_jax(host_jl, name, n, route):
    """Kernel J's phases give JAX build_bitmap's bitmap and build_count's
    count, by either route, on a full grid and on a grid of 3 blocks (each
    warp walks several tiles)."""
    plan, cols, valid, jbits, jcount = _mask_case(name, n)
    for max_blocks in (1 << 20, 3):
        bits, count, grid, ticket = _host_mask(host_jl, plan, cols, valid, route, max_blocks)
        assert np.array_equal(bits.numpy(), jbits), (max_blocks, grid)
        assert count == jcount and ticket == 0, (max_blocks, grid)


@pytest.mark.parametrize("route", ["value", "table"])
@pytest.mark.parametrize("name", _MASK_PLANS)
def test_host_topk_rows_as_jax(host_jl, name, route):
    """Kernel K's row test (eval_row on the plan J takes, valid applied),
    row by row, packs to JAX build_bitmap's bitmap, by either route."""
    plan, cols, valid, jbits, jcount = _mask_case(name, _MASK_NS[1])
    n = valid.shape[0]
    args, _kept = _host_plan(plan, cols, route)
    mask = torch.full((n,), 7, dtype=torch.uint8)
    host_jl.host_rows(*args, valid.data_ptr(), n, mask.data_ptr())
    assert set(mask.unique().tolist()) <= {0, 1}
    assert np.array_equal(np.packbits(mask.numpy().astype(bool)), jbits)
    assert int(mask.sum()) == jcount


def test_host_mask_twice_leaves_no_state(host_jl):
    """Two launches on one scratch with no reset between them, the second
    with its blocks finishing in the other order and a smaller grid: each
    count is JAX's and each leaves the scratch word at 0."""
    plan, cols, valid, jbits, jcount = _mask_case("leaves_13", _MASK_NS[-1])
    scratch = torch.zeros(ts.MASK_SCRATCH_BYTES, dtype=torch.uint8)
    grids = []
    for max_blocks, reverse in ((1 << 20, False), (5, True), (1 << 20, True)):
        bits, count, grid, ticket = _host_mask(host_jl, plan, cols, valid, "value", max_blocks,
                                               scratch, reverse)
        assert count == jcount and ticket == 0 and np.array_equal(bits.numpy(), jbits)
        grids.append(grid)
    assert grids[0] > 5 and grids[1] == 5


def test_host_value_plan_layout_is_the_kernels(host_jl):
    """ops/scan.py's ValuePlan and the mask scratch it allocates have
    csrc/scan.cu's sizes."""
    import ctypes

    sizes = (ctypes.c_longlong * 2)()
    host_jl.host_sizes(sizes)
    assert sizes[0] == ctypes.sizeof(ts.ValuePlan)
    assert sizes[1] == ts.MASK_SCRATCH_BYTES


def test_mask_route_by_plan_size():
    """Up to PLAN_LEAVES leaves and PLAN_INS instructions the plan goes by
    value; past either, as a table. Constant leaves take no entry."""
    col = torch.zeros(64, dtype=torch.int64)

    def route(n_leaves, op=ts.OP_GT):
        leaves = ((ts.COL_I64, op, 0),) * n_leaves
        plan = ts.ScanPlan(_chain(n_leaves, ("and", "or")), leaves, ("t",),
                           np.zeros(n_leaves, np.int64), np.zeros(n_leaves))
        return ts.plan_route(*ts.decode_plan(plan, [col]))

    assert route(ts.PLAN_LEAVES) == "value"
    assert route(ts.PLAN_LEAVES + 1) == "table"
    assert route(ts.PLAN_INS // 2 + 1, ts.OP_TRUE) == "table"
    mixed = ts.ScanPlan(("and", 0, ("or", 1, 2)), ((ts.COL_I64, ts.OP_TRUE, 0),
                                                    (ts.COL_I64, ts.OP_GT, 0),
                                                    (ts.COL_I64, ts.OP_FALSE, 0)),
                        ("t",), np.asarray([0, 7, 0], np.int64), np.zeros(3))
    entries, ins = ts.decode_plan(mixed, [col])
    assert entries == [(col.data_ptr(), 7, ts.KIND_CODE[ts.COL_I64] | ts.OP_GT << 8)]
    assert sorted(ins) == sorted([ts.T_TRUE, ts.T_LEAF, ts.T_FALSE, ts.T_OR, ts.T_AND])
    with pytest.raises(ValueError):
        ts.value_plan([(0, 0, 0)] * (ts.PLAN_LEAVES + 1), [ts.T_LEAF] * 3)


@pytest.mark.parametrize("b", [1, 64, 512])
def test_host_apply_as_jax(host_jl, b):
    """Kernel L's unit over every (column, row) of its grid and the packed
    plain version give JAX build_apply's columns: negative and out-of-range
    indices, pads, int64, float64 and bool columns, the delta packed as the
    view packs it."""
    n = 600
    rng = np.random.default_rng(b)
    real = max(1, b - b // 8)
    rows = rng.choice(n - 1, real, replace=False).astype(np.int64)
    rows[: max(1, real // 8)] -= n  # the same rows, as negative indices
    rows[0] = -1  # row n - 1
    if real > 2:
        rows[-1] = n + 5  # out of range: dropped
        rows[-2] = -n - 3  # below -N: dropped
    host_vals = [rng.integers(-5, 5, n).astype(np.int64), rng.random(n), rng.random(n) < 0.5]
    host_vals[1][:50] = np.nan
    cols = [rng.integers(-9, 9, n).astype(np.int64), rng.choice([np.nan, -0.0, 1.5], n),
            rng.random(n) < 0.5]
    # the delta's values: the host columns at the (wrapped, clipped) rows
    srcs = [np.concatenate([v, v]) for v in host_vals]
    at = np.clip(np.where(rows < 0, rows + n, rows), 0, n - 1)
    block = np.zeros(ts.apply_layout([8, 8, 1], b)[1], np.uint8)
    ts.pack_delta(block, at, srcs, b, pad=n)
    block[:8 * real].view(np.int64)[:] = rows  # the indices as given, wrap and drop included
    idx = block[:8 * b].view(np.int64).copy()
    vals = [block[off:off + v.itemsize * b].view(v.dtype).copy()
            for off, v in zip(ts.apply_layout([8, 8, 1], b)[0], host_vals)]
    want = js.build_apply(tuple(str(c.dtype) for c in cols))(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(idx), tuple(jnp.asarray(v) for v in vals))
    got = [torch.from_numpy(c.copy()) for c in cols]
    table = ts.apply_table(got)
    host_jl.host_apply(table.data_ptr(), len(got), block.ctypes.data, b, n)
    plain = ts.scan_apply_packed_plain([torch.from_numpy(c.copy()) for c in cols],
                                       torch.from_numpy(block), b)
    for g, p, w in zip(got, plain, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes() == p.numpy().tobytes()


def test_apply_layout_takes_8_byte_columns_first():
    assert ts.apply_layout([8, 8, 1], 64) == ([512, 1024, 1536], 1600)
    for sizes in ([1, 8], [8, 4], [2]):
        with pytest.raises(ValueError):
            ts.apply_layout(sizes, 64)


def test_scan_constants_are_the_kernels():
    """Kernel J's rows a lane, threads and plan capacity, and kernel L's
    threads, are csrc/scan.cu's."""
    import pathlib
    import re

    src = (pathlib.Path(ts.__file__).parents[1] / "csrc" / "scan.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int ([JL]_\w+) = (\d+);", src)}
    assert consts["J_ROWS"] == ts.MASK_ROWS
    assert consts["J_THREADS"] == ts.MASK_THREADS
    assert consts["J_PLAN_LEAVES"] == ts.PLAN_LEAVES
    assert consts["J_PLAN_INS"] == ts.PLAN_INS
    assert consts["L_THREADS"] == ts.APPLY_THREADS
