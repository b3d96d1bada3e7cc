"""The canonical payload row and its CRC32, worked out from a reference
state.

`payload_rows` is a frozen copy of the port's plain payload
(ops/payload.py payload_rows_narrow_plain, at the state's own layout):
the scalars, the current branch's version history, then the five pending
lists, each count-prefixed and sorted with PAD after the ids. The CRC is
zlib's IEEE CRC32 over each row's little-endian int64 words, the
checksum flavour the configuration states; `word_bytes=4` hashes the
rows narrowed to int32 words, the control's lower precision.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from .layout import PAD, PayloadLayout
from .state import ReplayState


def _sorted_ids(occ: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return torch.sort(torch.where(occ, ids, torch.full_like(ids, PAD)), dim=1).values


def payload_rows(s: ReplayState, layout: PayloadLayout) -> torch.Tensor:
    """[W, layout.width] int64 canonical payload of each workflow."""
    W = s.state.shape[0]
    Kv = layout.max_version_history_items
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
    vh_pairs = torch.stack([vh_event_ids[:, :Kv], vh_versions[:, :Kv]], dim=2).reshape(W, 2 * Kv)

    blocks = [scalars, vh_count.to(torch.int64)[:, None], vh_pairs]
    for table, ids, cap in ((s.timers, s.timers.started_id, layout.max_timers),
                            (s.activities, s.activities.schedule_id, layout.max_activities),
                            (s.children, s.children.initiated_id, layout.max_children),
                            (s.signals, s.signals.initiated_id, layout.max_signals),
                            (s.cancels, s.cancels.initiated_id, layout.max_request_cancels)):
        cnt = table.occ.sum(dim=1).to(torch.int64)
        blocks += [cnt[:, None], _sorted_ids(table.occ, ids)[:, :cap]]
    rows = torch.cat(blocks, dim=1)
    if rows.shape[1] != layout.width:
        raise AssertionError(f"payload width {rows.shape[1]}, layout {layout.width}")
    return rows


def crc32_of_rows(rows: np.ndarray, word_bytes: int = 8) -> np.ndarray:
    """[W] uint32: zlib's CRC32 of each row's little-endian words, int64
    words (`word_bytes=8`) or the row narrowed to int32 words (4)."""
    if word_bytes not in (4, 8):
        raise ValueError(f"word_bytes: 4 or 8, not {word_bytes}")
    words = np.ascontiguousarray(rows, dtype="<i8")
    if word_bytes == 4:
        words = np.ascontiguousarray(words.astype("<i4"))
    return np.fromiter((zlib.crc32(r.tobytes()) for r in words), dtype=np.uint32,
                       count=len(words))
