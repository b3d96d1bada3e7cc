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
"""
from __future__ import annotations

import ctypes
import functools

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
    (kernel G does not check them)."""
    if isinstance(rows, torch.Tensor) and rows.device == dev and dev.type != "cpu":
        return rows.to(torch.int64).contiguous()
    host = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows,
                      dtype=np.int64).reshape(-1)
    if host.size and (host.min() < lo or host.max() >= hi):
        raise ValueError(f"{what}: a row outside [{lo}, {hi})")
    if distinct and len(np.unique(host)) != len(host):
        raise ValueError(f"{what}: a destination row appears twice")
    return torch.from_numpy(host).to(dev)


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
