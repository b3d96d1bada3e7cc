"""Columnar visibility scans: query AST -> per-row mask, count, bitmap,
top-k page, and the delta scatter that keeps the columns current.

The JAX package's ops/scan.py in two halves:

- the host half, copied as it is: the op and column codes,
  `UnsupportedPredicate`, `ScanPlan`, `plan_leaf_int`, `compile_plan` and
  `pow2_bucket`. `compile_plan` gives the JAX one's signature, iparams and
  fparams for the same AST and binder;
- the device half, as functions on tensors that take the plan at run
  time. Nothing compiles per shape, so the JAX package's `build_*`
  closures and their kernel-variant cache have no counterpart here.

The device half on the card (csrc/scan.cu):

- `scan_count` and `scan_bitmap` are kernel J: the plan's predicate per
  row, `& valid`, summed, and with a bitmap packed 1 bit a row in numpy's
  big bit order. The count needs no memset: its scratch (the blocks'
  tickets and count in one word) is zeroed once for each stream;
- `scan_topk` is kernel K (`cadence_vis_topk`): the first k row ids in
  (matching first, start time descending, row ascending) order, and the
  count, by a radix select of the k-th row and a sort of the few rows at
  or before it (`topk_select_plain` states its stages in plain torch);
- `scan_apply` and `scan_apply_packed` are kernel L (`cadence_vis_apply`):
  one delta batch scattered into every column, pads and out-of-range
  indices dropped. The delta travels packed (`apply_layout`: the indices,
  then each column's values) beside the columns' pointer table
  (`apply_table`); `DeltaFeed` is the view's feed, one page-locked block
  reused by every drain, one copy and one launch a drain.

The plan reaches kernels J and K as a postfix program (`program`): one
int64 word per leaf or and/or node, the children of a node ordered so that
the deeper one runs first, which keeps the evaluation stack at most
log2(leaves) + 1 entries deep (the kernels hold it in one 64-bit register
a row). Both take it decoded (`decode_plan`) and by the same two routes
(`plan_route`): by value in the launch's parameters (`cadence_vis_mask`,
`cadence_vis_topk`; launch names "vis_mask", "vis_topk") up to
PLAN_LEAVES leaves and PLAN_INS instructions, else as a device table (the
`_table` entry points and launch names). On the CPU the wrappers run the plain versions below,
which evaluate the same program with a stack of bool tensors; on the card
they launch the kernel or raise. Each has a `*_launch` twin that makes
every check and argument first and returns the launch (see
_build.launcher).

Host parity is the contract: every op code reproduces the host
evaluator's semantics exactly — missing values never match, IEEE NaN
(the float column's null) never matches, and cross-type comparisons
reduce at PLAN time to constant TRUE/FALSE leaves mirroring Python's
`==`-is-False / `<`-is-TypeError split. Ordering comparisons on interned
string columns cannot be expressed on device (interning does not
preserve lexicographic order) — the binder refuses them and the store
falls back to the host path (counted, never silently divergent).
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..engine.visibility_query import And, Cmp, Node, Or
from . import _build

#: interned-id null (row has no value in this column)
NULL_ID = -1

#: leaf op codes (structural — part of the plan's signature)
OP_FALSE = 0    # never matches (cross-type ordering, unknown column)
OP_TRUE = 1     # always matches (e.g. int column != non-integral float)
OP_EQ = 2
OP_NE = 3       # guarded by presence on nullable columns
OP_LT = 4
OP_LE = 5
OP_GT = 6
OP_GE = 7
OP_PRESENT = 8  # matches iff the row has a value (id/f64 `!=` vs
                # cross-type constant: present values always differ)

#: column kinds (structural)
COL_ID = "id"    # int64 interned ids, NULL_ID = missing; EQ/NE/PRESENT
COL_I64 = "i64"  # int64, always present (times, status); all six ops
COL_F64 = "f64"  # float64 numeric search attrs, NaN = missing

_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)


class UnsupportedPredicate(Exception):
    """The query needs host evaluation (string ordering, a column past
    the intern budget, a type-poisoned column). Not an error: the store
    counts it (`reason` picks the fallback counter — "predicate" for an
    inexpressible op, "column" for a column the device cannot carry)
    and serves the host path."""

    def __init__(self, msg: str, reason: str = "predicate") -> None:
        super().__init__(msg)
        self.reason = reason


class ScanPlan:
    """One compiled query: the structural signature (hashable) plus this
    query's parameter vectors.

    `leaves` is a tuple of (kind, op_code, slot) triples; `tree` is the
    nested ("and"|"or"|int) structure over leaf indices. `slots` names
    the columns the kernels consume, in the order the store must pass
    them. Parameters are NOT part of the signature: they ride the
    int64/float64 vectors, so same-shape queries share one program
    structure."""

    def __init__(self, tree, leaves: Tuple, slots: Tuple[str, ...],
                 iparams, fparams) -> None:
        self.tree = tree
        self.leaves = leaves
        self.slots = slots
        self.iparams = iparams
        self.fparams = fparams

    @property
    def signature(self):
        return (self.tree, self.leaves, self.slots)

    def __hash__(self):
        return hash(self.signature)

    def __eq__(self, other):
        return (isinstance(other, ScanPlan)
                and self.signature == other.signature)


def plan_leaf_int(op: str, value: object):
    """Normalize a numeric comparison against an int64 column into an
    exact int64 (op_code, param) — or a constant leaf when Python-exact
    semantics say so. Python compares int/float EXACTLY (5 < 5.3 and
    5 == 5.0 are value comparisons, not casts); float64 cannot represent
    every int64, so the float is folded into the integer lattice here at
    plan time instead of casting the column on device."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        # bool is int in Python but never produced by the parser; any
        # non-numeric value vs an always-present int column: == False,
        # != True, ordering TypeError→False
        return {"!=": (OP_TRUE, 0)}.get(op, (OP_FALSE, 0))
    if isinstance(value, float):
        if value != value or value in (float("inf"), float("-inf")):
            if value == float("inf"):
                return ((OP_TRUE, 0) if op in ("<", "<=", "!=")
                        else (OP_FALSE, 0))
            if value == float("-inf"):
                return ((OP_TRUE, 0) if op in (">", ">=", "!=")
                        else (OP_FALSE, 0))
            return (OP_TRUE, 0) if op == "!=" else (OP_FALSE, 0)  # NaN
        if float(value).is_integer() and _INT64_MIN <= value <= _INT64_MAX:
            value = int(value)
        else:
            # non-integral: no int equals it; order against the floor
            f = math.floor(value)
            if f >= _INT64_MAX:
                lo_ops = ("<", "<=")
                return ((OP_TRUE, 0) if op in lo_ops or op == "!="
                        else (OP_FALSE, 0))
            if f < _INT64_MIN:
                hi_ops = (">", ">=")
                return ((OP_TRUE, 0) if op in hi_ops or op == "!="
                        else (OP_FALSE, 0))
            return {
                "=": (OP_FALSE, 0), "!=": (OP_TRUE, 0),
                "<": (OP_LE, f), "<=": (OP_LE, f),
                ">": (OP_GE, f + 1), ">=": (OP_GE, f + 1),
            }[op]
    if not _INT64_MIN <= value <= _INT64_MAX:
        # beyond int64: every stored value is on one known side
        if value > _INT64_MAX:
            return ((OP_TRUE, 0) if op in ("<", "<=", "!=")
                    else (OP_FALSE, 0))
        return ((OP_TRUE, 0) if op in (">", ">=", "!=")
                else (OP_FALSE, 0))
    return {"=": (OP_EQ, value), "!=": (OP_NE, value),
            "<": (OP_LT, value), "<=": (OP_LE, value),
            ">": (OP_GT, value), ">=": (OP_GE, value)}[op]


def compile_plan(node: Node, binder) -> ScanPlan:
    """Walk the AST into a ScanPlan. `binder.leaf(field, op, value)`
    resolves one comparison into (kind, op_code, slot_name, iparam,
    fparam) — the store owns column naming, interning and budget — and
    raises UnsupportedPredicate to route the whole query to the host."""
    leaves = []
    slots: list = []
    iparams: list = []
    fparams: list = []

    def walk(n):
        if isinstance(n, And):
            return ("and", walk(n.left), walk(n.right))
        if isinstance(n, Or):
            return ("or", walk(n.left), walk(n.right))
        assert isinstance(n, Cmp)
        kind, op_code, slot_name, ip, fp = binder.leaf(n.field, n.op,
                                                       n.value)
        if slot_name is None:
            slot = -1
        else:
            if slot_name not in slots:
                slots.append(slot_name)
            slot = slots.index(slot_name)
        leaves.append((kind, op_code, slot))
        iparams.append(int(ip))
        fparams.append(float(fp))
        return len(leaves) - 1

    tree = walk(node)
    return ScanPlan(tree, tuple(leaves), tuple(slots),
                    np.asarray(iparams, dtype=np.int64),
                    np.asarray(fparams, dtype=np.float64))


def pow2_bucket(n: int, floor: int = 64) -> int:
    """Smallest pow2 ≥ max(n, floor) — delta batches and capacities land
    on shared shapes instead of minting one per exact size."""
    b = floor
    while b < n:
        b <<= 1
    return b


# ---------------------------------------------------------------------------
# The plan as a postfix program (what kernels J and K and the plain
# versions run)
# ---------------------------------------------------------------------------

#: instruction tags, the low byte of a program word
T_FALSE, T_TRUE, T_LEAF, T_AND, T_OR = range(5)
#: a leaf word's column kind, bits 8-15
KIND_CODE = {COL_ID: 0, COL_I64: 1, COL_F64: 2}
#: the deepest evaluation stack kernel J holds (one uint64 register)
MAX_STACK = 64

_I64_OPS = (OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE)
_F64_OPS = _I64_OPS + (OP_PRESENT,)


def program(plan: ScanPlan) -> Tuple[list, int]:
    """(int64 words, stack depth) of the plan in postfix order. A leaf
    word is T_LEAF | kind << 8 | op << 16 | slot << 24 | leaf index << 40
    (OP_FALSE and OP_TRUE leaves become the constants T_FALSE and T_TRUE);
    an and/or word is its tag. Of a node's two children the one needing
    the deeper stack runs first (and/or over masks commute), so the depth
    is at most log2(leaves) + 1; a plan past MAX_STACK all the same is
    refused as UnsupportedPredicate, the counted host fallback."""
    def emit(n):
        if isinstance(n, tuple):
            op, left, right = n
            lw, ld = emit(left)
            rw, rd = emit(right)
            if rd > ld:
                lw, ld, rw, rd = rw, rd, lw, ld
            return lw + rw + [T_AND if op == "and" else T_OR], max(ld, rd + 1)
        kind, op, slot = plan.leaves[n]
        if op == OP_FALSE:
            return [T_FALSE], 1
        if op == OP_TRUE:
            return [T_TRUE], 1
        if not (kind == COL_ID or (kind == COL_I64 and op in _I64_OPS)
                or (kind == COL_F64 and op in _F64_OPS)) or slot < 0:
            raise ValueError(f"leaf {n}: op {op} on a {kind} column (slot {slot})")
        return [T_LEAF | KIND_CODE[kind] << 8 | op << 16 | slot << 24 | n << 40], 1

    words, depth = emit(plan.tree)
    if depth > MAX_STACK:
        raise UnsupportedPredicate(f"plan needs a stack of {depth} (> {MAX_STACK})")
    return words, depth


# Kernel J's constants (csrc/scan.cu): threads a block, rows a lane takes
# in a warp's tile, the by-value plan's capacity, the count's scratch bytes
# (one word: tickets and the count so far).
MASK_THREADS = 256
MASK_ROWS = 4
PLAN_LEAVES = 32
PLAN_INS = 64
MASK_SCRATCH_BYTES = 8
#: kernel L's threads a block (a block is one column's rows)
APPLY_THREADS = 256


class ValuePlan(ctypes.Structure):
    """csrc/scan.cu's ValuePlan: the decoded plan kernel J takes by value."""
    _fields_ = [("col", ctypes.c_int64 * PLAN_LEAVES), ("param", ctypes.c_int64 * PLAN_LEAVES),
                ("code", ctypes.c_int32 * PLAN_LEAVES), ("n_ins", ctypes.c_int32),
                ("n_entries", ctypes.c_int32), ("ins", ctypes.c_uint8 * PLAN_INS)]


def decode_plan(plan: ScanPlan, cols) -> Tuple[list, list]:
    """(entries, instructions) of the plan's program as kernel J runs it:
    an entry (column pointer, parameter as int64 bits, kind | op << 8) for
    each leaf instruction in program order (the kernel tests entry e at
    the e-th leaf instruction and loads the next ones ahead), and each
    instruction as tag | entry << 3 (the constants and and/or keep their
    tags)."""
    words, _ = program(plan)
    fbits = np.asarray(plan.fparams, dtype=np.float64).view(np.int64)
    entries, ins = [], []
    for w in words:
        tag = w & 0xFF
        if tag == T_LEAF:
            kind, op, slot, leaf = (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFFFF, w >> 40
            param = fbits[leaf] if kind == KIND_CODE[COL_F64] else plan.iparams[leaf]
            ins.append(T_LEAF | len(entries) << 3)
            entries.append((cols[slot].data_ptr(), int(param), kind | op << 8))
        else:
            ins.append(tag)
    return entries, ins


def plan_route(entries, ins) -> str:
    """The route of decode_plan's output into kernels J and K: "value" (in
    the launch's parameters) when it has at most PLAN_LEAVES entries and
    PLAN_INS instructions, else "table" (copied to the card)."""
    return "value" if len(entries) <= PLAN_LEAVES and len(ins) <= PLAN_INS else "table"


def value_plan(entries, ins) -> ValuePlan:
    """The by-value form of decode_plan's output."""
    if len(entries) > PLAN_LEAVES or len(ins) > PLAN_INS:
        raise ValueError(f"{len(entries)} leaves, {len(ins)} instructions: past the by-value "
                         f"plan's {PLAN_LEAVES} and {PLAN_INS}")
    vp = ValuePlan()
    for e, (col, param, code) in enumerate(entries):
        vp.col[e], vp.param[e], vp.code[e] = col, param, code
    vp.n_ins, vp.n_entries = len(ins), len(entries)
    for i, w in enumerate(ins):
        vp.ins[i] = w
    return vp


def table_plan(entries, ins) -> list:
    """The device-table form of decode_plan's output: [columns][parameters]
    [codes][instructions], int64 each."""
    return ([c for c, _, _ in entries] + [p for _, p, _ in entries] + [k for _, _, k in entries]
            + list(ins))


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and what chip_smoke.py holds each kernel to)
# ---------------------------------------------------------------------------

def _leaf_plain(kind: int, op: int, col: torch.Tensor, ip: int, fp: float) -> torch.Tensor:
    if kind == KIND_CODE[COL_F64]:
        present = ~torch.isnan(col)
        if op == OP_NE:
            return present & (col != fp)
        if op == OP_PRESENT:
            return present
        # IEEE: every comparison against NaN is already False
        return {OP_EQ: col == fp, OP_LT: col < fp, OP_LE: col <= fp,
                OP_GT: col > fp, OP_GE: col >= fp}[op]
    if kind == KIND_CODE[COL_ID]:
        if op == OP_EQ:
            return col == ip
        if op == OP_NE:
            return (col != NULL_ID) & (col != ip)
        return col != NULL_ID  # OP_PRESENT
    return {OP_EQ: col == ip, OP_NE: col != ip, OP_LT: col < ip,
            OP_LE: col <= ip, OP_GT: col > ip, OP_GE: col >= ip}[op]


def mask_plain(plan: ScanPlan, cols: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """[N] bool: the plan's predicate per row, & valid — the plan's
    program run over a stack of bool tensors."""
    words, _ = program(plan)
    stack = []
    for w in words:
        tag = w & 0xFF
        if tag in (T_AND, T_OR):
            b, a = stack.pop(), stack.pop()
            stack.append(a & b if tag == T_AND else a | b)
        elif tag == T_LEAF:
            leaf = w >> 40
            stack.append(_leaf_plain((w >> 8) & 0xFF, (w >> 16) & 0xFF, cols[(w >> 24) & 0xFFFF],
                                     int(plan.iparams[leaf]), float(plan.fparams[leaf])))
        else:
            stack.append(torch.full_like(valid, tag == T_TRUE))
    return stack.pop() & valid


def scan_count_plain(plan, cols, valid) -> torch.Tensor:
    """int64 scalar: rows whose mask is set."""
    return mask_plain(plan, cols, valid).sum(dtype=torch.int64)


#: numpy's big bit order: row 8j is bit 7 of byte j
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def scan_bitmap_plain(plan, cols, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint8 [ceil(N/8)], int64 scalar): the mask packed as jnp.packbits
    packs it, an [N/8, 8] weighted sum, and the count."""
    mask = mask_plain(plan, cols, valid)
    pad = -mask.shape[0] % 8
    m = torch.cat([mask, mask.new_zeros(pad)]) if pad else mask
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=m.device)
    bits = (m.view(-1, 8).to(torch.int32) * weights).sum(1).to(torch.uint8)
    return bits, mask.sum(dtype=torch.int64)


def topk_order_plain(mask: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Every row id in the JAX package's lexsort((arange, -start, ~mask))
    order: two stable sorts, first by -start (which wraps, so a row with
    start INT64_MIN sorts first among its part), then by ~mask."""
    neg = torch.where(start == _INT64_MIN, start, -start.clamp(min=_INT64_MIN + 1))
    order = torch.sort(neg, stable=True).indices
    return order[torch.sort((~mask[order]).to(torch.uint8), stable=True).indices]


# Kernel K's select route (csrc/scan.cu): the constants it is built with.
#: composite bits one histogram pass fixes
TOPK_DIGIT = 12
#: the boundary bucket the passes may leave
TOPK_CAP = 4096
#: candidates the sort takes; above TOPK_SELECT_MAX, k takes the full sort
TOPK_SORT_MAX = 16384
TOPK_SELECT_MAX = TOPK_SORT_MAX - TOPK_CAP
_SIGN = 1 << 63
_U64 = (1 << 64) - 1


def topk_route(n: int, k: int) -> str:
    """Which route kernel K takes for k of n rows: "select" (a radix select
    of the k-th row, then a sort of at most k - 1 + TOPK_CAP candidates) or
    "sort" (a bitonic sort of all n rows, n a power of two)."""
    return "select" if k <= TOPK_SELECT_MAX else "sort"


def _composite_digit(ukey: torch.Tensor, row: torch.Tensor, lo: int, d: int) -> torch.Tensor:
    """Bits [lo, lo + d) of ukey << 32 | row, ukey's uint64 bits held in an
    int64 tensor (the masked low bits of an arithmetic shift are a logical
    shift's)."""
    v = (ukey >> (lo - 32)) if lo >= 32 else (ukey << (32 - lo)) | (row >> lo)
    return v & ((1 << d) - 1)


def _s64(u: int) -> int:
    """The int64 holding uint64 bits u."""
    return u - (1 << 64) if u >= _SIGN else u


def topk_select_plain(mask: torch.Tensor, start: torch.Tensor, k: int, digit: int = TOPK_DIGIT,
                      cap: int = TOPK_CAP) -> torch.Tensor:
    """Kernel K's select route, stage by stage, in plain torch: the first k
    row ids of topk_order_plain. The composite (!mask, key, row) orders the
    rows, key = (uint64)(-start) ^ sign bit. The k-th row lies in one part
    (the matches when k <= count, else the rest); from the first composite
    bit that differs inside that part, each pass histograms the next
    `digit` bits over the part's rows that share the prefix fixed so far
    and fixes the digit of the bucket that holds the k-th rank, until that
    bucket holds at most `cap` rows. The candidates (that part's rows at
    or below the bucket, and every match when the part is the rest) are
    sorted and the first k kept."""
    n = mask.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=mask.device)
    # pass 1: the keys (uint64 bits in int64), the count, each part's range
    ukey = (-start) ^ _INT64_MIN  # -start wraps, as (0 - (uint64)start) does
    skey = -start                # the same order as signed int64
    count = int(mask.sum())
    part = 0 if k <= count else 1
    need = k if part == 0 else k - count
    in_part = mask if part == 0 else ~mask
    lo_k = (int(skey[in_part].min()) ^ _SIGN) & _U64  # least key, uint64
    hi_k = (int(skey[in_part].max()) ^ _SIGN) & _U64
    if lo_k != hi_k:
        hb = (lo_k ^ hi_k).bit_length()
        pos, pk = 32 + hb, lo_k & ~((1 << hb) - 1) & _U64
    else:
        pos, pk = (n - 1).bit_length(), lo_k
    pr = 0
    done = int(in_part.sum()) <= cap or pos == 0
    # pass 2: the digit histograms
    while not done:
        d = min(digit, pos)
        lo = pos - d
        hi_bits = pos - 32
        if pos >= 96:
            inb = in_part
        elif pos >= 32:
            inb = in_part & ((ukey >> hi_bits) == (_s64(pk) >> hi_bits))
        else:
            inb = in_part & (ukey == _s64(pk)) & ((rows >> pos) == (pr >> pos))
        hist = torch.bincount(_composite_digit(ukey[inb], rows[inb], lo, d), minlength=1 << d)
        cum = torch.cumsum(hist, 0)
        b = int(torch.searchsorted(cum, torch.tensor(need)))
        need -= int(cum[b - 1]) if b else 0
        if lo >= 32:
            pk |= b << (lo - 32)
        else:
            pr |= (b << lo) & 0xFFFFFFFF
            pk |= b >> (32 - lo)
        pos = lo
        done = int(hist[b]) <= cap or pos == 0
    # pass 3: the candidates, at most k - 1 + cap of them
    hk = pk | ((1 << (pos - 32)) - 1) if pos > 32 else pk
    hr = 0xFFFFFFFF if pos >= 32 else pr | ((1 << pos) - 1)
    hk_s = _s64((hk ^ _SIGN) & _U64)  # the bound in skey's signed order
    at_most = (skey < hk_s) | ((skey == hk_s) & (rows <= hr))
    cand = (mask & (part == 1)) | (in_part & at_most)
    assert int(cand.sum()) <= k - 1 + cap
    # pass 4: sort them by (!mask, key, row) and keep k
    ids = rows[cand]
    return ids[topk_order_plain(mask[cand], start[cand])][:k]


def scan_topk_plain(plan, k: int, cols, valid, start) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 [k], int64 scalar): the first k row ids in (matching first,
    start DESC, row ASC) order, and the match count."""
    mask = mask_plain(plan, cols, valid)
    return topk_order_plain(mask, start)[:k], mask.sum(dtype=torch.int64)


def scan_apply_plain(cols: Sequence[torch.Tensor], idx: torch.Tensor,
                     vals: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Write vals[c][b] to cols[c][idx[b]] in place, as `c.at[idx].set(v,
    mode="drop")`: a negative index wraps once (NumPy-style), then every
    index outside [0, N) is dropped. Returns the columns."""
    n = cols[0].shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    keep = (idx >= 0) & (idx < n)
    rows = idx[keep]
    for c, v in zip(cols, vals):
        c.index_copy_(0, rows, v[keep])
    return tuple(cols)


def apply_layout(sizes: Sequence[int], b: int) -> Tuple[list, int]:
    """(each column's value offset, total bytes) of a packed delta of b
    rows for columns of these element sizes: b int64 indices, then each
    column's b values in column order. The sizes are 8 or 1, 8-byte
    columns first, so that every 8-byte block stays aligned."""
    if any(sz not in (1, 8) for sz in sizes) or list(sizes) != sorted(sizes, reverse=True):
        raise ValueError(f"apply_layout: element sizes {list(sizes)}; kernel L takes 8-byte "
                         f"columns, then 1-byte ones")
    offsets, off = [], 8 * b
    for sz in sizes:
        offsets.append(off)
        off += sz * b
    return offsets, off


def pack_delta(block: np.ndarray, rows: np.ndarray, host_cols: Sequence[np.ndarray], b: int,
               pad: int) -> None:
    """Pack one delta into `block` (uint8, apply_layout's bytes): the
    changed rows' indices padded to b with `pad` (past every column, so
    dropped), then each host column's values at those rows."""
    offsets, total = apply_layout([c.itemsize for c in host_cols], b)
    n = len(rows)
    idx = block[:8 * b].view(np.int64)
    idx[:n] = rows
    idx[n:] = pad
    for off, col in zip(offsets, host_cols):
        block[off:off + col.itemsize * b].view(col.dtype)[:n] = col[rows]


def scan_apply_packed_plain(cols: Sequence[torch.Tensor], block: torch.Tensor,
                            b: int) -> Tuple[torch.Tensor, ...]:
    """Kernel L's packed form in plain torch: the indices and each column's
    values read from `block` (uint8, apply_layout's bytes), then
    scan_apply_plain."""
    offsets, _ = apply_layout([c.element_size() for c in cols], b)
    idx = block[:8 * b].view(torch.int64)
    vals = [block[off:off + c.element_size() * b].view(c.dtype) for off, c in zip(offsets, cols)]
    return scan_apply_plain(cols, idx, vals)


def apply_table(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Kernel L's pointer table for `cols` (8-byte columns first), on their
    device: [C column pointers][C element sizes][C value offsets, bytes a
    row before each column's values]. `key` names the columns it was built
    for (pointer and size each)."""
    sizes = [c.element_size() for c in cols]
    offsets, _ = apply_layout(sizes, 1)
    words = [c.data_ptr() for c in cols] + sizes + [off - 8 for off in offsets]
    dev = cols[0].device
    table = (_to_card(words, torch.int64, dev) if dev.type == "cuda"
             else torch.tensor(words, dtype=torch.int64))
    table.key = _table_key(cols)
    return table


def _table_key(cols) -> tuple:
    return tuple((c.data_ptr(), c.element_size()) for c in cols)


# ---------------------------------------------------------------------------
# Wrappers: the plain version on the CPU, kernels J, K and L on the card
# ---------------------------------------------------------------------------

def _device_of(valid: torch.Tensor, what: str) -> torch.device:
    dev = valid.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _to_card(words, dtype, dev: torch.device) -> torch.Tensor:
    """A small host table copied to the card behind the launches queued
    on its current stream (through page-locked memory, so the copy does
    not wait for them)."""
    return torch.tensor(words, dtype=dtype).pin_memory().to(dev, non_blocking=True)


def _check_columns(plan: ScanPlan, cols, valid: torch.Tensor, what: str) -> None:
    """Raise unless kernels J and K take these: N a multiple of 64 below
    2^31, valid [N] bool, each column contiguous, [N] on valid's card, int64
    (id, i64) or float64 (f64)."""
    n = valid.shape[0]
    if n < 64 or n % 64 or n >= 1 << 31:
        raise ValueError(f"{what}: {n} rows; the kernels take a multiple of 64 below 2^31")
    _build.require(valid, torch.bool, (n,), f"{what} valid")
    if len(cols) != len(plan.slots):
        raise ValueError(f"{what}: {len(cols)} columns for {len(plan.slots)} slots")
    kinds = {}
    for kind, _op, slot in plan.leaves:
        if slot >= 0:
            kinds[slot] = kind
    for slot, col in enumerate(cols):
        dtype = torch.float64 if kinds.get(slot) == COL_F64 else torch.int64
        _build.require(col, dtype, (n,), f"{what} column {plan.slots[slot]!r}", valid.device)


def _plan_launcher(name: str, plan: ScanPlan, cols, valid: torch.Tensor, *rest):
    """Kernel `name` (vis_mask or vis_topk) for the plan, after checking
    every column: the decoded plan by value (entry point cadence_<name>,
    launch name `name`) or, past its capacity, as a device table
    (cadence_<name>_table, `name`_table), followed by `rest`."""
    _check_columns(plan, cols, valid, name)
    entries, ins = decode_plan(plan, cols)
    lib = _build.load()
    if plan_route(entries, ins) == "value":
        vp = value_plan(entries, ins)
        launch = _build.launcher(name, getattr(lib, f"cadence_{name}"), ctypes.addressof(vp),
                                 *rest)
        launch.plan = vp  # the launch copies it into the kernel's parameters
    else:
        table = _to_card(table_plan(entries, ins), torch.int64, valid.device)
        launch = _build.launcher(f"{name}_table", getattr(lib, f"cadence_{name}_table"), table,
                                 len(entries), len(ins), *rest)
    launch.outputs = tuple(cols)  # the plan points into them
    return launch


#: kernel J's count scratch (its blocks' tickets and count in one word),
#: zeroed once for each (device, stream); the last block of every launch
#: puts it back to 0
_MASK_SCRATCH: dict = {}


def _mask_scratch(dev: torch.device) -> torch.Tensor:
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev, stream)
    scratch = _MASK_SCRATCH.get(key)
    if scratch is None:
        scratch = torch.zeros(MASK_SCRATCH_BYTES, dtype=torch.uint8, device=dev)
        _MASK_SCRATCH[key] = scratch
    return scratch


def scan_count(plan: ScanPlan, cols, valid: torch.Tensor) -> torch.Tensor:
    """int64 scalar match count: kernel J on the card, the plain version
    on the CPU."""
    if _device_of(valid, "scan_count").type == "cpu":
        return scan_count_plain(plan, cols, valid)
    with torch.cuda.device(valid.device):
        launch, out = scan_count_launch(plan, cols, valid)
        launch()
    return out


def scan_count_launch(plan: ScanPlan, cols, valid: torch.Tensor):
    """Check what kernel J takes; return (its launch, the int64 scalar it
    writes)."""
    launch, (_, count) = _mask_launch(plan, cols, valid, bitmap=False)
    return launch, count


def scan_bitmap(plan: ScanPlan, cols, valid: torch.Tensor):
    """(uint8 [N/8] bitmap, int64 scalar count): kernel J on the card, the
    plain version on the CPU."""
    if _device_of(valid, "scan_bitmap").type == "cpu":
        return scan_bitmap_plain(plan, cols, valid)
    with torch.cuda.device(valid.device):
        launch, out = scan_bitmap_launch(plan, cols, valid)
        launch()
    return out


def scan_bitmap_launch(plan: ScanPlan, cols, valid: torch.Tensor):
    """Check what kernel J takes; return (its launch, (bitmap, count))."""
    return _mask_launch(plan, cols, valid, bitmap=True)


def _mask_launch(plan, cols, valid, bitmap: bool):
    n, dev = valid.shape[0], valid.device
    count = torch.empty((), dtype=torch.int64, device=dev)
    bits = torch.empty((n // 8,), dtype=torch.uint8, device=dev) if bitmap else None
    launch = _plan_launcher("vis_mask", plan, cols, valid, valid, n, count, bits,
                            _mask_scratch(dev), _build.stream_of(valid))
    return launch, (bits, count)


def scan_topk(plan: ScanPlan, k: int, cols, valid: torch.Tensor, start: torch.Tensor):
    """(int64 [k] row ids, int64 scalar count): kernel K on the card, the
    plain version on the CPU."""
    if _device_of(valid, "scan_topk").type == "cpu":
        return scan_topk_plain(plan, k, cols, valid, start)
    with torch.cuda.device(valid.device):
        launch, out = scan_topk_launch(plan, k, cols, valid, start)
        launch()
    return out


def scan_topk_launch(plan: ScanPlan, k: int, cols, valid: torch.Tensor, start: torch.Tensor):
    """Check what kernel K takes; return (its launch, (ids, count)). Its
    scratch (the select's state, a bitmap and the candidates, about N/8
    bytes; or 12 bytes a row for the full sort) is allocated here."""
    n = valid.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"scan_topk: k = {k} for {n} rows")
    if topk_route(n, k) == "sort" and n & (n - 1):
        raise ValueError(f"scan_topk: k = {k} above {TOPK_SELECT_MAX} sorts all rows, and "
                         f"{n} rows are not a power of two")
    _build.require(start, torch.int64, (n,), "scan_topk start", valid.device)
    dev = valid.device
    lib = _build.load()
    scratch = torch.empty((lib.cadence_vis_topk_scratch(n, k),), dtype=torch.uint8, device=dev)
    ids = torch.empty((k,), dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    launch = _plan_launcher("vis_topk", plan, cols, valid, valid, start, n, k, scratch, ids, count,
                            _build.stream_of(valid))
    return launch, (ids, count)


def scan_apply(cols: Sequence[torch.Tensor], idx: torch.Tensor,
               vals: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Scatter one delta batch into every column, in place: kernel L on
    the card, the plain version on the CPU. Returns the columns. The
    indices must be distinct once wrapped (the view never passes a
    duplicate); pads and indices outside [-N, N) are dropped."""
    if _device_of(idx, "scan_apply").type == "cpu":
        return scan_apply_plain(cols, idx, vals)
    with torch.cuda.device(idx.device):
        launch, out = scan_apply_launch(cols, idx, vals)
        launch()
    return out


def scan_apply_launch(cols: Sequence[torch.Tensor], idx: torch.Tensor,
                      vals: Sequence[torch.Tensor]):
    """Check what kernel L takes; pack the delta on the card (8-byte
    columns first) beside a pointer table; return (its launch, the columns
    it writes in place)."""
    if not cols or len(cols) != len(vals):
        raise ValueError(f"scan_apply: {len(cols)} columns, {len(vals)} value tensors")
    n, b = cols[0].shape[0], idx.shape[0]
    _build.require(idx, torch.int64, (b,), "scan_apply idx")
    for i, (c, v) in enumerate(zip(cols, vals)):
        if c.element_size() not in (1, 8):
            raise ValueError(f"scan_apply: column {i} has {c.element_size()}-byte elements")
        _build.require(c, c.dtype, (n,), f"scan_apply column {i}", idx.device)
        _build.require(v, c.dtype, (b,), f"scan_apply values {i}", idx.device)
    order = sorted(range(len(cols)), key=lambda i: -cols[i].element_size())
    ordered = [cols[i] for i in order]
    packed = torch.cat([idx.view(torch.uint8)] + [vals[i].view(torch.uint8) for i in order])
    table = apply_table(ordered)
    launch = _build.launcher("vis_apply", _build.load().cadence_vis_apply, table, len(cols),
                             packed, b, n, _build.stream_of(idx))
    launch.outputs = tuple(cols)
    return launch, tuple(cols)


def scan_apply_packed(cols: Sequence[torch.Tensor], table: torch.Tensor, block: torch.Tensor,
                      dev_block, b: int) -> Tuple[torch.Tensor, ...]:
    """Scatter a packed delta of b rows (`block`: host uint8, apply_layout's
    bytes) into `cols` in place: on the card one copy of the block into
    `dev_block` and one launch of kernel L with `table` (apply_table of
    these columns); on the CPU scan_apply_packed_plain. Returns the
    columns."""
    if _device_of(cols[0], "scan_apply_packed").type == "cpu":
        return scan_apply_packed_plain(cols, block, b)
    with torch.cuda.device(cols[0].device):
        launch, out = apply_packed_launch(cols, table, block, dev_block, b)
        launch()
    return out


def apply_packed_launch(cols: Sequence[torch.Tensor], table: torch.Tensor, block: torch.Tensor,
                        dev_block: torch.Tensor, b: int):
    """Check what kernel L takes; return (the launch: the block's copy to
    the card, then kernel L; the columns it writes in place). The launch's
    `copy` is its first step alone, `args` and `name` its kernel's."""
    if not cols:
        raise ValueError("scan_apply_packed: no columns")
    n, dev = cols[0].shape[0], cols[0].device
    _, nbytes = apply_layout([c.element_size() for c in cols], b)
    for i, c in enumerate(cols):
        _build.require(c, c.dtype, (n,), f"scan_apply_packed column {i}", dev)
    if getattr(table, "key", None) != _table_key(cols):
        raise ValueError("scan_apply_packed: the pointer table was built for other columns")
    _build.require(table, torch.int64, (3 * len(cols),), "scan_apply_packed table", dev)
    if block.device.type != "cpu" or block.dtype != torch.uint8 or block.numel() < nbytes:
        raise ValueError(f"scan_apply_packed: the block must hold {nbytes} host bytes")
    if dev_block.device != dev or dev_block.dtype != torch.uint8 or dev_block.numel() < nbytes:
        raise ValueError(f"scan_apply_packed: the device block must hold {nbytes} bytes on {dev}")
    run = _build.launcher("vis_apply", _build.load().cadence_vis_apply, table, len(cols),
                          dev_block, b, n, _build.stream_of(dev_block))
    src, dst = block[:nbytes], dev_block[:nbytes]

    def copy():
        dst.copy_(src, non_blocking=True)

    def launch():
        copy()
        run()

    launch.copy, launch.args, launch.name = copy, run.args, run.name
    launch.outputs = tuple(cols)
    return launch, tuple(cols)


class DeltaFeed:
    """Kernel L's feed for one view: a host block (page-locked for a card)
    that every drain packs its delta into, reused and grown by doubling;
    its twin on the card; and the columns' pointer table on the card,
    rebuilt only when the columns change (another pointer or size: a
    restage, growth, a new attribute column). A drain is one copy and one
    launch."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._host = None
        self._dev = None
        self._copied = None  # the event after the last copy out of the host block
        self.table = None
        #: pointer tables built so far
        self.table_builds = 0

    def block(self, nbytes: int) -> np.ndarray:
        """The host block's first nbytes as uint8, once the last copy out
        of it is done."""
        if self._copied is not None:
            self._copied.synchronize()
        if self._host is None or self._host.numel() < nbytes:
            cap = max(nbytes, 2 * self._host.numel() if self._host is not None else 0)
            self._host = torch.empty(cap, dtype=torch.uint8,
                                     pin_memory=self.device.type == "cuda")
        return self._host.numpy()[:nbytes]

    def send(self, cols: Sequence[torch.Tensor], b: int) -> Tuple[torch.Tensor, ...]:
        """Apply the packed delta of b rows in the block to `cols`."""
        if self.table is None or self.table.key != _table_key(cols):
            self.table = apply_table(cols)
            self.table_builds += 1
        if self.device.type == "cpu":
            return scan_apply_packed(cols, self.table, self._host, None, b)
        if self._dev is None or self._dev.numel() < self._host.numel():
            self._dev = torch.empty(self._host.numel(), dtype=torch.uint8, device=self.device)
        out = scan_apply_packed(cols, self.table, self._host, self._dev, b)
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(self.device))
        return out
