"""Re-homing state rows between batches and layouts (kernel G), and the
narrow-layout fit test (kernel H).

The JAX package re-homes ReplayState rows in six places, each a jitted
program over the 66 state tensors: ops/state.py `widen_state` and
`narrow_state`, engine/resident.py `_stack_states` and `_slice_row`, and
engine/ladder.py's pad concatenate and survivor gather. Here one kernel,
csrc/rehome.cu `cadence_rehome`, does all of them: out row i is
src[src_rows[i]] at `out_layout` (source -1: an init row), written to a
new state or to dst[dst_rows[i]]. ops/state.py `narrow_ok` is kernel H,
`cadence_narrow_ok`.

On the CPU the wrappers run the plain versions (ops/state.py
`rehome_plain`, `narrow_ok_plain`); on the card they launch the kernel or
raise. Each has a `*_launch` twin that makes every check and the argument
list first and returns the launch (see _build.launcher).

Kernel G walks (field, row, unit): `work_table` is the table its launcher
derives from the two layouts, and `rehome_walk_plain` the walk in plain
torch ops, which the tests hold to `rehome_plain` and the JAX package.
"""
from __future__ import annotations

import bisect
import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.checksum import PayloadLayout
from . import _build
from .state import (ReplayState, empty_state, init_state, layout_of, leaves, narrow_ok_plain,
                    rehome_plain)


@functools.lru_cache(maxsize=None)
def _field_table():
    """(init value, element bytes) of every state field in csrc/state.cuh
    order, from init_state: what kernel G writes into an init slot."""
    ref = [(t.reshape(-1)[0].item() if t.numel() else 0, t.element_size())
           for _, t in leaves(init_state(1, PayloadLayout(), "cpu"))]
    init = (ctypes.c_int64 * len(ref))(*(int(v) for v, _ in ref))
    sizes = (ctypes.c_int * len(ref))(*(size for _, size in ref))
    return init, sizes


def _index_tensor(rows, dev: torch.device, what: str, lo: int, hi: int,
                  distinct: bool = False) -> torch.Tensor:
    """Row indices as a contiguous int64 tensor on `dev`. Host indices are
    checked before they are copied over: each in [lo, hi), and distinct
    when asked. Indices already on a card are the caller's to guarantee
    (kernel G does not check them). Host indices go to a card through
    page-locked memory by a copy queued on the current stream, which the
    host does not wait for: a copy from pageable memory would wait for
    every kernel queued before it (a serving flush's gather behind kernel
    A). PyTorch's page-locked allocator keeps the staging block from reuse
    until the copy has completed."""
    if isinstance(rows, torch.Tensor) and rows.device == dev and dev.type != "cpu":
        return rows.to(torch.int64).contiguous()
    host = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows,
                      dtype=np.int64).reshape(-1)
    if host.size and (host.min() < lo or host.max() >= hi):
        raise ValueError(f"{what}: a row outside [{lo}, {hi})")
    if distinct and len(np.unique(host)) != len(host):
        raise ValueError(f"{what}: a destination row appears twice")
    if dev.type != "cuda":
        return torch.from_numpy(host).to(dev)
    return torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)


def rehome(src: ReplayState, src_rows, out_layout: PayloadLayout,
           dst: ReplayState = None, dst_rows=None) -> ReplayState:
    """Out row i = src[src_rows[i]] re-homed at `out_layout` (source -1:
    an init row): a new state of len(src_rows) rows, or written into `dst`
    at dst_rows (distinct) and `dst` returned. Kernel G on the card, the
    plain version on the CPU."""
    dev = src.state.device
    if dev.type == "cpu":
        src_rows = _index_tensor(src_rows, dev, "src_rows", -1, src.state.shape[0])
        if dst is not None:
            dst_rows = _index_tensor(dst_rows, dev, "dst_rows", 0, dst.state.shape[0],
                                     distinct=True)
        return rehome_plain(src, src_rows, out_layout, dst, dst_rows)
    if dev.type != "cuda":
        raise ValueError(f"rehome: unsupported device {dev}")
    with torch.cuda.device(dev):
        launch, out = rehome_launch(src, src_rows, out_layout, dst, dst_rows)
        launch()
    return out


def rehome_launch(src: ReplayState, src_rows, out_layout: PayloadLayout,
                  dst: ReplayState = None, dst_rows=None):
    """Check what kernel G takes; return (its launch, the state it writes)."""
    dev = src.state.device
    s_rows = _index_tensor(src_rows, dev, "src_rows", -1, src.state.shape[0])
    n = s_rows.shape[0]
    if dst is None:
        if dst_rows is not None:
            raise ValueError("rehome: dst_rows without dst")
        dst = empty_state(n, out_layout, dev)
        d_rows = torch.arange(n, dtype=torch.int64, device=dev)
    else:
        if layout_of(dst) != out_layout:
            raise ValueError(f"rehome: dst is at {layout_of(dst)}, expected {out_layout}")
        d_rows = _index_tensor(dst_rows, dev, "dst_rows", 0, dst.state.shape[0],
                               distinct=True)
        if d_rows.shape[0] != n:
            raise ValueError(f"rehome: {n} source rows, {d_rows.shape[0]} destination rows")
    lay_in = layout_of(src)
    init, sizes = _field_table()
    launch = _build.launcher(
        "rehome", _build.load().cadence_rehome, _build.state_pointer_table(src),
        _build.caps(lay_in), lay_in.max_branches, lay_in.max_version_history_items,
        _build.state_pointer_table(dst), _build.caps(out_layout), out_layout.max_branches,
        out_layout.max_version_history_items, s_rows, d_rows, n, init, sizes,
        _build.stream_of(src.state))
    launch.outputs = (src, dst)  # the tensors the pointer tables point into
    return launch, dst


#: csrc/rehome.cu: threads a block and units a thread; a block moves
#: REHOME_THREADS * REHOME_ITEMS units of one field
REHOME_THREADS, REHOME_ITEMS = 128, 1


class FieldWork(NamedTuple):
    """One field's entry in kernel G's work table."""
    unit: int         # bytes a unit: the element's, or 2-16 for whole rows
    whole: bool       # the same capacity in and out: rows move whole
    units: int        # units an out row
    first_block: int  # the field's first block of the launch


@functools.lru_cache(maxsize=None)
def _dims(layout: PayloadLayout) -> Tuple[Tuple[int, int], ...]:
    """Each field's per-row shape as [a, b] (csrc/rehome.cu dims): scalars
    [1, 1], tables [1, K], version-history items [B, Kv], vh_count [1, B]."""
    shapes = (tuple(t.shape[1:]) for _, t in leaves(init_state(1, layout, "meta")))
    return tuple((1, 1) if not shape else (1, shape[0]) if len(shape) == 1 else shape
                 for shape in shapes)


def work_table(in_layout: PayloadLayout, out_layout: PayloadLayout, n: int,
               src_ptrs: Optional[Sequence[int]] = None,
               dst_ptrs: Optional[Sequence[int]] = None) -> Tuple[List[FieldWork], int]:
    """Kernel G's work table for n rows, as its launcher derives it (field
    order of csrc/state.cuh), and the blocks of the launch. A field at the
    same capacity moves whole rows in units of 16 bytes where its row bytes
    and both pointers (each field's address; None: aligned, as the card's
    allocator gives them) allow, else of the largest of 8, 4 and 2 that
    does, else an element a unit; a field whose capacity changes moves an
    element a unit."""
    _, sizes = _field_table()
    per_block = REHOME_THREADS * REHOME_ITEMS
    table, blocks = [], 0
    for f, ((ai, bi), (ao, bo)) in enumerate(zip(_dims(in_layout), _dims(out_layout))):
        size = sizes[f]
        row = ao * bo * size
        whole = (ai, bi) == (ao, bo)
        unit = size
        if whole:
            sp = 0 if src_ptrs is None else src_ptrs[f]
            dp = 0 if dst_ptrs is None else dst_ptrs[f]
            unit = next((ub for ub in (16, 8, 4, 2) if ub > size and row % ub == 0
                         and sp % ub == 0 and dp % ub == 0), size)
        units = row // unit if whole else ao * bo
        table.append(FieldWork(unit, whole, units, blocks))
        blocks += -(-units * n // per_block)
    return table, blocks


def rehome_walk_plain(src: ReplayState, src_rows, out_layout: PayloadLayout,
                      dst: ReplayState = None, dst_rows=None) -> ReplayState:
    """Plain version of kernel G's walk: work_table for these tensors, each
    block's field found from the table's first blocks as the kernel finds
    it, and every (row, unit) of that field moved as the kernel moves it
    (whole-row units as bytes; an element a unit where the capacity
    changes, past the source's capacity the init value; source -1 an init
    row). The same contract as rehome_plain."""
    dev = src.state.device
    rows = torch.as_tensor(src_rows, dtype=torch.int64).to(dev).reshape(-1)
    n = rows.shape[0]
    if dst is None:
        dst = empty_state(n, out_layout, dev)
        d_rows = torch.arange(n, dtype=torch.int64, device=dev)
    else:
        d_rows = torch.as_tensor(dst_rows, dtype=torch.int64).to(dev).reshape(-1)
    if n == 0:
        return dst
    lay_in = layout_of(src)
    table, blocks = work_table(lay_in, out_layout, n,
                               [t.data_ptr() for _, t in leaves(src)],
                               [t.data_ptr() for _, t in leaves(dst)])
    firsts = [w.first_block for w in table]
    init, sizes = _field_table()
    per_block = REHOME_THREADS * REHOME_ITEMS
    n_src = src.state.shape[0]
    for f, ((_, s_t), (_, d_t), w, (ai, bi), (_, bo)) in enumerate(zip(
            leaves(src), leaves(dst), table, _dims(lay_in), _dims(out_layout))):
        last = table[f + 1].first_block if f + 1 < len(table) else blocks
        for b in range(w.first_block, last):  # each block finds this field
            if bisect.bisect_right(firsts, b) - 1 != f:
                raise AssertionError(f"block {b} does not find field {f}")
        u = torch.arange((last - w.first_block) * per_block, device=dev)
        u = u[u < n * w.units]
        r, k = u // w.units, u % w.units
        s, d = rows[r], d_rows[r]
        live = s >= 0
        if w.whole:
            size = sizes[f]
            init_bytes = torch.tensor([init[f]], dtype=torch.int64).view(torch.uint8)[:size]
            val = init_bytes.repeat(w.unit // size).to(dev).expand(u.shape[0], w.unit).clone()
            if n_src and bool(live.any()):
                sb = s_t.reshape(n_src, -1).view(torch.uint8).reshape(n_src, w.units, w.unit)
                val[live] = sb[s[live], k[live]]
            db = d_t.reshape(d_t.shape[0], -1).view(torch.uint8)
            db.reshape(d_t.shape[0], w.units, w.unit)[d, k] = val
        else:
            x, y = k // bo, k % bo
            live = live & (x < ai) & (y < bi)
            val = torch.full((u.shape[0],), init[f], dtype=torch.int64, device=dev).to(d_t.dtype)
            if n_src and bool(live.any()):
                flat = s_t.reshape(n_src, -1)
                val[live] = flat[s[live], x[live] * bi + y[live]]
            d_t.reshape(d_t.shape[0], -1)[d, k] = val
    return dst


def narrow_ok(s: ReplayState, out_layout: PayloadLayout) -> torch.Tensor:
    """[W] bool of rows whose state fits `out_layout` exactly: kernel H on
    the card, the plain version on the CPU."""
    dev = s.state.device
    if dev.type == "cpu":
        return narrow_ok_plain(s, out_layout)
    if dev.type != "cuda":
        raise ValueError(f"narrow_ok: unsupported device {dev}")
    with torch.cuda.device(dev):
        launch, out = narrow_ok_launch(s, out_layout)
        launch()
    return out


def narrow_ok_launch(s: ReplayState, out_layout: PayloadLayout):
    """Check what kernel H takes; return (its launch, the [W] bool output
    it writes)."""
    W = s.state.shape[0]
    lay_in = layout_of(s)
    out = torch.empty((W,), dtype=torch.bool, device=s.state.device)
    launch = _build.launcher(
        "narrow_ok", _build.load().cadence_narrow_ok, _build.state_pointer_table(s),
        _build.caps(lay_in), lay_in.max_branches, lay_in.max_version_history_items,
        _build.caps(out_layout), out_layout.max_branches, out_layout.max_version_history_items,
        out, W, _build.stream_of(s.state))
    launch.outputs = (s,)
    return launch, out
