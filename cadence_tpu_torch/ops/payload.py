"""Canonical checksum payload assembly on the device.

Produces, from the dense ReplayState, the same [W, width] int64 payload
matrix as the oracle's core/checksum.payload_row (field order per the
reference's checksum.go). `payload_rows_narrow` launches kernel B
(csrc/payload.cu) for a state on the GPU and takes the plain PyTorch
version, `payload_rows_narrow_plain`, for a state on the CPU. Asked for,
the same launch also gives each row's fit to the output layout
(ops/state.py `narrow_ok`, kernel H's function) and the state's [2] error
and closed counts (ops/stats.py `stats`, kernel F's function): the paths
that need them take them from kernel B's epilogues, not from H or F.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.checksum import DEFAULT_LAYOUT, PAD, PayloadLayout
from . import _build
from .state import ReplayState, layout_of, narrow_ok_plain
from .stats import stats_plain


def _sorted_ids(occ: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.sort(torch.where(occ, ids, torch.full_like(ids, int(PAD))), dim=1).values


def payload_rows(s: ReplayState, layout: PayloadLayout = DEFAULT_LAYOUT) -> torch.Tensor:
    """[W, layout.width] int64 canonical payload, comparable elementwise with
    the oracle's payload_row."""
    rows, _overflow = payload_rows_narrow(s, layout)
    return rows


def payload_rows_narrow_plain(s: ReplayState, out_layout: PayloadLayout, fit: bool = False,
                              counts: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel B: project a (possibly widened-K)
    state's canonical payload to `out_layout`'s width. Returns (rows
    [W, out_layout.width] int64, overflow [W] bool), a row whose final
    counts exceed an out capacity flagged; then, with `fit`, the [W] bool
    of rows that fit `out_layout` exactly (narrow_ok_plain) and, with
    `counts`, the [2] int64 [rows with an error, rows closed]
    (stats_plain)."""
    W = s.state.shape[0]
    Kv = out_layout.max_version_history_items
    scalars = torch.stack([
        s.cancel_requested.to(torch.int64),
        s.state.to(torch.int64),
        s.last_first_event_id,
        s.next_event_id,
        s.last_processed_event,
        s.signal_count,
        s.decision_attempt,
        s.decision_schedule_id,
        s.decision_started_id,
        s.decision_version,
        torch.zeros((W,), dtype=torch.int64, device=s.state.device),
    ], dim=1)
    bidx = s.current_branch.to(torch.int64)
    Kv_s = s.vh_event_ids.shape[2]
    index = bidx[:, None, None].expand(W, 1, Kv_s)
    vh_event_ids = torch.gather(s.vh_event_ids, 1, index).squeeze(1)
    vh_versions = torch.gather(s.vh_versions, 1, index).squeeze(1)
    vh_count = torch.gather(s.vh_count, 1, bidx[:, None]).squeeze(1)
    overflow = vh_count.to(torch.int64) > Kv
    vh_pairs = torch.stack([vh_event_ids[:, :Kv], vh_versions[:, :Kv]], dim=2).reshape(W, 2 * Kv)

    blocks = [scalars, vh_count.to(torch.int64)[:, None], vh_pairs]
    for table, ids, cap in ((s.timers, s.timers.started_id, out_layout.max_timers),
                            (s.activities, s.activities.schedule_id, out_layout.max_activities),
                            (s.children, s.children.initiated_id, out_layout.max_children),
                            (s.signals, s.signals.initiated_id, out_layout.max_signals),
                            (s.cancels, s.cancels.initiated_id, out_layout.max_request_cancels)):
        cnt = table.occ.sum(dim=1).to(torch.int64)
        overflow = overflow | (cnt > cap)
        blocks += [cnt[:, None], _sorted_ids(table.occ, ids)[:, :cap]]
    rows = torch.cat(blocks, dim=1)
    assert rows.shape[1] == out_layout.width, (rows.shape, out_layout.width)
    out = (rows, overflow)
    if fit:
        out += (narrow_ok_plain(s, out_layout),)
    if counts:
        out += (stats_plain(s.error, s.close_status),)
    return out


def payload_rows_narrow(s: ReplayState, out_layout: PayloadLayout, fit: bool = False,
                        counts: bool = False) -> Tuple[torch.Tensor, ...]:
    """(rows [W, out_layout.width] int64, overflow [W] bool), then the fit
    flags [W] bool with `fit` and the [2] int64 counts with `counts`, as
    payload_rows_narrow_plain gives them: kernel B (with those epilogues)
    on the GPU, the plain version on the CPU."""
    dev = s.state.device
    if dev.type == "cpu":
        return payload_rows_narrow_plain(s, out_layout, fit, counts)
    if dev.type != "cuda":
        raise ValueError(f"payload_rows_narrow: unsupported device {dev}")
    launch, *outputs = payload_launch(s, out_layout, fit, counts)
    launch()
    return tuple(outputs)


#: kernel B's counts scratch, [2] int64 (the running total and the ticket,
#: 0 between launches), one a (device, stream): launches on one stream run
#: in turn, so they never share it at once
_counts_scratch: Dict[tuple, torch.Tensor] = {}


def counts_scratch(dev: torch.device, stream) -> torch.Tensor:
    """The counts scratch of `stream` (a ctypes handle) on `dev`, made
    zero on that stream at first use."""
    key = (dev, stream.value)
    got = _counts_scratch.get(key)
    if got is None:
        got = _counts_scratch.setdefault(key, torch.zeros((2,), dtype=torch.int64, device=dev))
    return got


def payload_launch(s: ReplayState, out_layout: PayloadLayout, fit: bool = False,
                   counts: bool = False):
    """Check what kernel B takes; return (its launch, the rows and the
    overflow flags it writes, then the fit flags with `fit` and the [2]
    counts with `counts`)."""
    dev = s.state.device
    lay = layout_of(s)
    for name, cap, have in (
            ("max_version_history_items", out_layout.max_version_history_items,
             lay.max_version_history_items),
            ("max_activities", out_layout.max_activities, lay.max_activities),
            ("max_timers", out_layout.max_timers, lay.max_timers),
            ("max_children", out_layout.max_children, lay.max_children),
            ("max_request_cancels", out_layout.max_request_cancels, lay.max_request_cancels),
            ("max_signals", out_layout.max_signals, lay.max_signals)):
        if cap > have:
            raise ValueError(f"out_layout.{name}={cap} is wider than the state's {have}")
    W = s.state.shape[0]
    rows = torch.empty((W, out_layout.width), dtype=torch.int64, device=dev)
    overflow = torch.empty((W,), dtype=torch.bool, device=dev)
    fit_t = torch.empty((W,), dtype=torch.bool, device=dev) if fit else None
    counts_t = torch.empty((2,), dtype=torch.int64, device=dev) if counts else None
    stream = _build.stream_of(rows)
    launch = _build.launcher(
        "payload", _build.load().cadence_payload, _build.state_pointer_table(s), rows,
        overflow, W, _build.caps(lay), lay.max_branches, lay.max_version_history_items,
        _build.caps(out_layout), out_layout.max_version_history_items, out_layout.width,
        out_layout.max_branches, fit_t, counts_t,
        counts_scratch(dev, stream) if counts else None, stream,
        also=("payload_fit",) * fit + ("payload_counts",) * counts)
    return (launch, rows, overflow) + ((fit_t,) if fit else ()) + ((counts_t,) if counts else ())
