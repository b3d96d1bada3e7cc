"""The batched replay entry points: apply every workflow's events, reduce
to the canonical payload row, hash it, and compare.

On the GPU the event loop is kernel A (csrc/replay_kernel.cuh): one thread per
workflow scans its events and updates its state in place; `replay_scan`
updates the state in place on the CPU too. Kernel A takes one of two
routes, chosen here from the state's layout before the launch
(`replay_route`): the staged route, which holds the tables' occupancy, the
lookup keys and the version histories on the chip, for every table
capacity up to CHIP_MAX_K; the global route, which reads them from device
memory, for the rest (the ladder's rung 3 and up). Each route counts its
launches under its own name (`_build.launches`: "replay", "replay_tasks",
"replay_wirec"; "replay_global", ...). On the CPU the loop
is `replay_scan_plain`, a Python loop of ops/transitions.step over the
event axis (the JAX package's `lax.scan`). The wirec entry points do the
same through `wirec_scan`: kernel A's wirec reader decodes each event in
the loop; `wirec_scan_plain` runs ops/wirec.decode_step_plain before each
step. Each entry point has the JAX package's signature plus `device`:
None means the GPU, and on a machine without CUDA that raises rather than
running on the CPU; the CPU is used only when the caller asks for it
(`device="cpu"`).

CRCs are unsigned 32-bit values: int64 tensors holding the unsigned value
inside torch, np.uint32 at the numpy boundary (`replay_corpus`).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout
from ..core.events import HistoryBatch
from ..device import resolve_device
from . import _build
from .crc import crc32_rows
from .encode import (
    LANE32_A4_HI,
    LANE32_TS_HI,
    LANE_A0,
    LANE_TIMESTAMP,
    NUM_LANES,
    NUM_LANES32,
    encode_corpus,
)
from .payload import payload_rows, payload_rows_narrow
from .state import ReplayState, init_state, layout_of, leaves, map_state
from .taskgen import TaskLog, field_spec, init_task_log, retention_nanos, step_tasks
from .transitions import step
from .wirec import (check_profile, decode_step_plain, delta_base_columns, profile_table,
                    wirec_inputs)


#: csrc/replay_tables.cuh: the most slots a table's occupancy mask holds;
#: the workflows a staged block holds; (state.cuh) the most shared memory a
#: block may have; the branches whose version history stays in registers
CHIP_MAX_K = 64
STAGED_WF = 32
SMEM_LIMIT = 232448
REG_BRANCHES = 2


def staged_block(layout: PayloadLayout) -> Tuple[int, int]:
    """(workflows a block, dynamic shared-memory bytes) of kernel A's staged
    route at `layout`, as csrc/replay_kernel.cuh staged_block chooses them; (0, 0)
    for a layout of the global route."""
    if max(layout.max_activities, layout.max_timers, layout.max_children,
           layout.max_request_cancels, layout.max_signals) > CHIP_MAX_K:
        return 0, 0
    keys = (2 * layout.max_activities + layout.max_timers + layout.max_children
            + layout.max_request_cancels + layout.max_signals)
    B = layout.max_branches
    smem = STAGED_WF * (8 * keys + (20 * B if B > REG_BRANCHES else 0))
    return (STAGED_WF, smem) if smem <= SMEM_LIMIT else (0, 0)


def replay_route(layout: PayloadLayout) -> str:
    """Kernel A's route at `layout`: "staged" (tables and version histories
    on the chip) where the layout has a staged block, else "global"."""
    return "staged" if staged_block(layout)[0] else "global"


def launch_name(name: str, layout: PayloadLayout) -> str:
    """The launch name (a key of _build.launches; its C entry point is
    "cadence_" + it) of kernel A's `name` launch ("replay", "replay_tasks",
    "replay_wirec") on the layout's route."""
    return name if replay_route(layout) == "staged" else name + "_global"


def _entry(name: str, layout: PayloadLayout):
    """(launch name, C entry point) of kernel A's `name` launch on the
    layout's route."""
    name = launch_name(name, layout)
    return name, getattr(_build.load(), "cadence_" + name)


def _lanes(events, dev: torch.device, dtype: torch.dtype, lanes: int) -> torch.Tensor:
    t = torch.as_tensor(events)
    if t.dim() != 3 or t.shape[2] != lanes or t.dtype != dtype:
        raise ValueError(f"events: expected [W, E, {lanes}] {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    return t.to(dev).contiguous()


def widen_wire32(ev32: torch.Tensor) -> torch.Tensor:
    """[.., NUM_LANES32] int32 → [.., NUM_LANES] int64, rebuilding the two
    wide lanes exactly from their lo/hi halves (encode.to_wire32)."""
    base = ev32[..., :NUM_LANES].to(torch.int64)
    lo_ts = ev32[..., LANE_TIMESTAMP].to(torch.int64) & 0xFFFFFFFF
    ts = (ev32[..., LANE32_TS_HI].to(torch.int64) << 32) | lo_ts
    lo_a4 = ev32[..., LANE_A0 + 4].to(torch.int64) & 0xFFFFFFFF
    a4 = (ev32[..., LANE32_A4_HI].to(torch.int64) << 32) | lo_a4
    base[..., LANE_TIMESTAMP] = ts
    base[..., LANE_A0 + 4] = a4
    return base


def replay_scan_plain(s0: ReplayState, events: torch.Tensor,
                      wire32: bool = False) -> ReplayState:
    """Plain PyTorch version of kernel A: step every workflow through its
    events [W, E, L] (int64 lanes, or int32 wire32 lanes widened per
    step). Returns the final state; `s0` is not modified."""
    s = s0
    for e in range(events.shape[1]):
        ev = events[:, e]
        s = step(s, widen_wire32(ev) if wire32 else ev)
    return s


def _copy_into(s: ReplayState, out: ReplayState) -> ReplayState:
    """Copy every tensor of `out` into `s` (the plain versions' result into
    the state the in-place entry points were given); returns `s`."""
    for (_, dst), (_, src) in zip(leaves(s), leaves(out)):
        dst.copy_(src)
    return s


def replay_scan(s: ReplayState, events: torch.Tensor, wire32: bool = False) -> ReplayState:
    """Apply events [W, E, L] to state `s`, IN PLACE on either device, and
    return `s`: kernel A on the GPU; on the CPU the plain version, whose
    result is copied back into `s`."""
    dev = s.state.device
    if events.device != dev:
        raise ValueError(f"events on {events.device}, state on {dev}")
    if dev.type == "cpu":
        return _copy_into(s, replay_scan_plain(s, events, wire32))
    if dev.type != "cuda":
        raise ValueError(f"replay: unsupported device {dev}")
    replay_launch(s, events, wire32)()
    return s


def replay_launch(s: ReplayState, events: torch.Tensor, wire32: bool = False):
    """Check what kernel A takes and return its launch, a call that runs
    the kernel on `s` in place (see _build.launcher)."""
    dev = s.state.device
    W = s.state.shape[0]
    lanes, dtype = (NUM_LANES32, torch.int32) if wire32 else (NUM_LANES, torch.int64)
    _build.require(events, dtype, (W, events.shape[1], lanes), "events", dev)
    lay = layout_of(s)
    return _build.launcher(
        *_entry("replay", lay), _build.state_pointer_table(s),
        events, W, events.shape[1], int(wire32), _build.caps(lay), lay.max_branches,
        lay.max_version_history_items, _build.stream_of(events))


def replay_events(events, layout: PayloadLayout = DEFAULT_LAYOUT,
                  device=None) -> ReplayState:
    """Replay packed events [W, E, 18] int64 from a fresh state; returns
    the final state."""
    dev = resolve_device(device)
    ev = _lanes(events, dev, torch.int64, NUM_LANES)
    return replay_scan(init_state(ev.shape[0], layout, dev), ev)


def replay_to_payload(events, layout: PayloadLayout = DEFAULT_LAYOUT,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay and reduce to (canonical payload rows [W, width], error [W])."""
    s = replay_events(events, layout, device)
    return payload_rows(s, layout), s.error


def replay_events32(events32, layout: PayloadLayout = DEFAULT_LAYOUT,
                    device=None) -> ReplayState:
    """Replay wire32-packed events [W, E, 20] int32; the lanes stay int32
    on the device and are widened per event."""
    dev = resolve_device(device)
    ev = _lanes(events32, dev, torch.int32, NUM_LANES32)
    return replay_scan(init_state(ev.shape[0], layout, dev), ev, wire32=True)


def replay_to_crc32(events32, layout: PayloadLayout = DEFAULT_LAYOUT,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """wire32 replay reduced to (crc32 [W] int64, error [W])."""
    s = replay_events32(events32, layout, device)
    return crc32_rows(payload_rows(s, layout)), s.error


def replay_from_state(events, s0: ReplayState, device=None) -> ReplayState:
    """Replay suffix events [W, E, 18] against a carried state `s0` (whose
    shapes give the layout); returns the final state. `s0` is copied to
    `device` and left as it was."""
    dev = resolve_device(device)
    ev = _lanes(events, dev, torch.int64, NUM_LANES)
    s = map_state(lambda t: t.to(dev, copy=True).contiguous(), s0)
    return replay_scan(s, ev)


def replay_from_state_to_payload(events, s0: ReplayState,
                                 out_layout: PayloadLayout = DEFAULT_LAYOUT,
                                 device=None):
    """From-state replay reduced to (final state, payload rows at
    `out_layout` width, error [W], narrow_overflow [W])."""
    s = replay_from_state(events, s0, device)
    rows, ovf = payload_rows_narrow(s, out_layout)
    return s, rows, s.error, ovf


def replay_from_state_to_crc(events, s0: ReplayState,
                             out_layout: PayloadLayout = DEFAULT_LAYOUT,
                             device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """From-state replay reduced to (crc32 [W] int64, error [W],
    narrow_overflow [W])."""
    s = replay_from_state(events, s0, device)
    rows, ovf = payload_rows_narrow(s, out_layout)
    return crc32_rows(rows), s.error, ovf


# ---------------------------------------------------------------------------
# Task-emitting replay: kernel A's TASKS variant (csrc/taskgen.cuh)
# ---------------------------------------------------------------------------


def replay_tasks_scan_plain(s0: ReplayState, log0: TaskLog, events: torch.Tensor,
                            wire32: bool = False,
                            retention_days: int = 1) -> Tuple[ReplayState, TaskLog]:
    """Plain PyTorch version of kernel A with tasks: per event column,
    ops/transitions.step then ops/taskgen.step_tasks on the post-step
    state. Returns (state, log); `s0` and `log0` are not modified."""
    s, log = s0, log0
    for e in range(events.shape[1]):
        ev = widen_wire32(events[:, e]) if wire32 else events[:, e]
        s = step(s, ev)
        s, log = step_tasks(s, ev, log, retention_days)
    return s, log


def replay_tasks_scan(s: ReplayState, log: TaskLog, events: torch.Tensor, wire32: bool = False,
                      retention_days: int = 1) -> Tuple[ReplayState, TaskLog]:
    """Apply events [W, E, L] to state `s` and append their tasks to `log`,
    both IN PLACE on either device, and return (s, log): kernel A with
    tasks on the GPU; on the CPU the plain version, whose results are
    copied back into `s` and `log`."""
    dev = s.state.device
    for name, t in (("events", events), ("log", log.tr_count)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, state on {dev}")
    if dev.type == "cpu":
        s_out, log_out = replay_tasks_scan_plain(s, log, events, wire32, retention_days)
        for dst, src in zip(log, log_out):
            dst.copy_(src)
        return _copy_into(s, s_out), log
    if dev.type != "cuda":
        raise ValueError(f"replay: unsupported device {dev}")
    replay_tasks_launch(s, log, events, wire32, retention_days)()
    return s, log


def replay_tasks_launch(s: ReplayState, log: TaskLog, events: torch.Tensor,
                        wire32: bool = False, retention_days: int = 1):
    """Check what kernel A with tasks takes and return its launch, a call
    that runs it on `s` and `log` in place (see _build.launcher)."""
    retention = retention_nanos(retention_days)
    dev = s.state.device
    W = s.state.shape[0]
    lanes, dtype = (NUM_LANES32, torch.int32) if wire32 else (NUM_LANES, torch.int64)
    _build.require(events, dtype, (W, events.shape[1], lanes), "events", dev)
    Tt, Tm = log.tr_type.shape[-1], log.tm_type.shape[-1]
    for name, t in zip(TaskLog._fields, log):
        _build.require(t, *field_spec(name, W, Tt, Tm), f"log.{name}", dev)
    lay = layout_of(s)
    launch = _build.launcher(
        *_entry("replay_tasks", lay), _build.state_pointer_table(s),
        (ctypes.c_uint64 * len(log))(*(t.data_ptr() for t in log)), events, W,
        events.shape[1], int(wire32), _build.caps(lay), lay.max_branches,
        lay.max_version_history_items, Tt, Tm, retention, _build.stream_of(events))
    launch.outputs = (s, log)  # the tensors the pointer tables point into
    return launch


def replay_events_with_tasks(events, layout: PayloadLayout = DEFAULT_LAYOUT,
                             max_transfer: int = 128, max_timer: int = 128,
                             retention_days: int = 1,
                             device=None) -> Tuple[ReplayState, TaskLog]:
    """Replay packed events [W, E, 18] int64 from a fresh state with task
    generation: returns (final state, TaskLog). The task-emitting variant
    of replay_events, the full stateBuilder analogue: the state also
    feeds the transfer and timer queues."""
    retention_nanos(retention_days)  # raise before any work, as the JAX package does
    dev = resolve_device(device)
    ev = _lanes(events, dev, torch.int64, NUM_LANES)
    W = ev.shape[0]
    return replay_tasks_scan(init_state(W, layout, dev),
                             init_task_log(W, max_transfer, max_timer, dev), ev,
                             retention_days=retention_days)


# ---------------------------------------------------------------------------
# wirec: the compressed lanes, decoded inside the event loop
# ---------------------------------------------------------------------------


def wirec_scan_plain(s0: ReplayState, slab: torch.Tensor, bases: torch.Tensor,
                     n_events: torch.Tensor, profile) -> ReplayState:
    """Plain PyTorch version of kernel A's wirec reader: per event column,
    the JAX package's decode_step then step. The DELTA carry starts from
    the `bases` columns delta_base_columns names. `s0` is not modified."""
    cols = list(delta_base_columns(profile))
    prev = bases[:, cols]
    s = s0
    for e in range(slab.shape[1]):
        ev, prev = decode_step_plain(slab[:, e], prev, bases, n_events, e, profile)
        s = step(s, ev)
    return s


def wirec_scan(s: ReplayState, slab: torch.Tensor, bases: torch.Tensor,
               n_events: torch.Tensor, profile) -> ReplayState:
    """Apply a wirec corpus to state `s` IN PLACE and return `s`: kernel A's
    wirec reader on the GPU, the plain version on the CPU."""
    dev = s.state.device
    for name, t in (("slab", slab), ("bases", bases), ("n_events", n_events)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, state on {dev}")
    if dev.type == "cpu":
        return _copy_into(s, wirec_scan_plain(s, slab, bases, n_events, profile))
    if dev.type != "cuda":
        raise ValueError(f"replay: unsupported device {dev}")
    wirec_launch(s, slab, bases, n_events, profile)()
    return s


def wirec_launch(s: ReplayState, slab: torch.Tensor, bases: torch.Tensor,
                 n_events: torch.Tensor, profile):
    """Check what kernel A's wirec reader takes and return its launch, a
    call that runs it on `s` in place (see _build.launcher)."""
    dev = s.state.device
    W = s.state.shape[0]
    if slab.dim() != 3:
        raise ValueError(f"slab: expected [W, E, B], got {tuple(slab.shape)}")
    _, E, B = slab.shape
    K = bases.shape[1] if bases.dim() == 2 else -1
    _build.require(slab, torch.uint8, (W, E, B), "slab", dev)
    _build.require(bases, torch.int64, (W, K), "bases", dev)
    _build.require(n_events, torch.int32, (W,), "n_events", dev)
    check_profile(tuple(profile), B, K)
    lay = layout_of(s)
    return _build.launcher(
        *_entry("replay_wirec", lay), _build.state_pointer_table(s),
        slab, bases, n_events, W, E, B, K, profile_table(profile), _build.caps(lay),
        lay.max_branches, lay.max_version_history_items, _build.stream_of(slab))


def replay_wirec(slab, bases, n_events, profile, layout: PayloadLayout = DEFAULT_LAYOUT,
                 device=None) -> ReplayState:
    """Replay a wirec corpus (ops/wirec.py: slab [W, E, B] uint8, bases
    [W, K] int64, n_events [W] int32, its profile) from a fresh state; the
    lanes are decoded one event at a time inside the loop and never exist
    as a dense tensor. Returns the final state."""
    dev = resolve_device(device)
    slab, bases, n_events = wirec_inputs(slab, bases, n_events, profile, dev)
    return wirec_scan(init_state(slab.shape[0], layout, dev), slab, bases, n_events, profile)


def replay_wirec_to_crc(slab, bases, n_events, profile,
                        layout: PayloadLayout = DEFAULT_LAYOUT,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """wirec replay reduced to (crc32 [W] int64, error [W]): compressed
    bytes up, 4 bytes per workflow down."""
    s = replay_wirec(slab, bases, n_events, profile, layout, device)
    return crc32_rows(payload_rows(s, layout)), s.error


def replay_wirec_from_state(slab, bases, n_events, profile, s0: ReplayState,
                            device=None) -> ReplayState:
    """From-state replay of a wirec SUFFIX corpus against a carried state
    `s0` (copied to `device` and left as it was). The suffix packs as a
    corpus of its own, so its decode starts from its own bases."""
    dev = resolve_device(device)
    slab, bases, n_events = wirec_inputs(slab, bases, n_events, profile, dev)
    s = map_state(lambda t: t.to(dev, copy=True).contiguous(), s0)
    return wirec_scan(s, slab, bases, n_events, profile)


def replay_wirec_from_state_to_payload(slab, bases, n_events, profile, s0: ReplayState,
                                       out_layout: PayloadLayout = DEFAULT_LAYOUT,
                                       device=None):
    """wirec from-state replay reduced to (final state, payload rows at
    `out_layout` width, error [W], narrow_overflow [W])."""
    s = replay_wirec_from_state(slab, bases, n_events, profile, s0, device)
    rows, ovf = payload_rows_narrow(s, out_layout)
    return s, rows, s.error, ovf


def replay_wirec_from_state_to_crc(slab, bases, n_events, profile, s0: ReplayState,
                                   out_layout: PayloadLayout = DEFAULT_LAYOUT,
                                   device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """wirec from-state replay reduced to (crc32 [W] int64, error [W],
    narrow_overflow [W])."""
    s = replay_wirec_from_state(slab, bases, n_events, profile, s0, device)
    rows, ovf = payload_rows_narrow(s, out_layout)
    return crc32_rows(rows), s.error, ovf


# ---------------------------------------------------------------------------
# Escalation rungs (engine/ladder.py): a flagged sub-corpus re-replayed at a
# widened capacity layout, projected back to the base payload width
# ---------------------------------------------------------------------------


def replay_escalated(events, layout: PayloadLayout,
                     out_layout: PayloadLayout = DEFAULT_LAYOUT, device=None):
    """One rung: replay [F, E, 18] lanes at the widened `layout`, then
    project the payload to `out_layout`. Returns (rows [F, out width],
    error [F], narrow_overflow [F], current_branch [F]); a row is resolved
    when its error is 0 and its overflow flag unset."""
    s = replay_events(events, layout, device)
    rows, ovf = payload_rows_narrow(s, out_layout)
    return rows, s.error, ovf, s.current_branch


def replay_escalated_state(events, layout: PayloadLayout,
                           out_layout: PayloadLayout = DEFAULT_LAYOUT, device=None):
    """replay_escalated that also returns the widened final state: (state,
    rows, error, narrow_overflow)."""
    s = replay_events(events, layout, device)
    rows, ovf = payload_rows_narrow(s, out_layout)
    return s, rows, s.error, ovf


def replay_wirec_escalated_crc(slab, bases, n_events, profile, layout: PayloadLayout,
                               out_layout: PayloadLayout = DEFAULT_LAYOUT, device=None):
    """One rung over a wirec sub-corpus: decode and replay at the widened
    `layout`, project to `out_layout`, hash. Returns (crc32 [F] int64,
    error [F], narrow_overflow [F])."""
    s = replay_wirec(slab, bases, n_events, profile, layout, device)
    rows, ovf = payload_rows_narrow(s, out_layout)
    return crc32_rows(rows), s.error, ovf


def verify_rows_plain(rows: torch.Tensor, expected_rows: torch.Tensor,
                      branch: torch.Tensor, expected_branch: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel D: [W] bool, row OR branch differs."""
    row_mismatch = (rows != expected_rows).any(dim=1)
    return row_mismatch | (branch != expected_branch.to(branch.dtype))


def verify_rows(rows, expected_rows, branch, expected_branch,
                device=None) -> torch.Tensor:
    """Per-workflow mismatch bit [W] bool: the payload row differs from the
    expected row, or the device-chosen current branch (int32) differs from
    the expected one. Kernel D on the GPU, the plain version on the CPU."""
    dev = resolve_device(device)
    rows = torch.as_tensor(rows).to(dev).contiguous()
    expected_rows = torch.as_tensor(expected_rows).to(dev).contiguous()
    branch = torch.as_tensor(branch).to(dev)
    expected_branch = torch.as_tensor(expected_branch).to(dev).to(branch.dtype)
    if dev.type == "cpu":
        return verify_rows_plain(rows, expected_rows, branch, expected_branch)
    launch, out = verify_launch(rows, expected_rows, branch, expected_branch)
    launch()
    return out


def verify_launch(rows, expected_rows, branch, expected_branch):
    """Check what kernel D takes (a row tensor off a 16-byte boundary is
    copied, as the kernel reads rows in 16-byte units); return (its launch,
    the [W] bool output it writes)."""
    dev = rows.device
    if rows.dim() != 2:
        raise ValueError(f"verify_rows: expected [W, width] rows, got {tuple(rows.shape)}")
    W, width = rows.shape
    _build.require(rows, torch.int64, (W, width), "rows", dev)
    _build.require(expected_rows, torch.int64, (W, width), "expected_rows", dev)
    rows, expected_rows = _build.aligned(rows), _build.aligned(expected_rows)
    branch = branch.contiguous()
    expected_branch = expected_branch.contiguous()
    _build.require(branch, torch.int32, (W,), "branch", dev)
    _build.require(expected_branch, torch.int32, (W,), "expected_branch", dev)
    out = torch.empty((W,), dtype=torch.bool, device=dev)
    return _build.launcher(
        "verify_rows", _build.load().cadence_verify_rows, rows, expected_rows, branch,
        expected_branch, out, W, width, _build.stream_of(rows)), out


def replay_corpus(histories: Sequence[Sequence[HistoryBatch]],
                  layout: PayloadLayout = DEFAULT_LAYOUT,
                  max_events: int = 0,
                  device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host helper: encode histories, replay on `device`, and return
    (payload_rows, crc32s, errors) as numpy arrays (crc32s as np.uint32,
    hashed on the device)."""
    dev = resolve_device(device)
    events = encode_corpus(histories, max_events)
    rows, errors = replay_to_payload(events, layout, dev)
    crcs = crc32_rows(rows)
    return (rows.cpu().numpy(), crcs.cpu().numpy().astype(np.uint32),
            errors.cpu().numpy())
