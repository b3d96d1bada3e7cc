"""The resident wire32 corpus, replayed by `ops/replay.py replay_to_crc32`.

Set-up makes the corpus's int64 lanes on the device, a block of
workflows at a time, counts each chunk's real events, and narrows them to wire32 (`narrow32`, a frozen
copy of the port's ops/encode.py to_wire32) into one resident [N, E, 20]
int32 tensor. A request hands the port one chunk of it, a view of
`chunk_workflows` rows; the port makes a fresh state (`init_state`),
replays it with kernel A's wire32 reader, builds the payload rows
(kernel B) and hashes them (kernel C).
"""
from __future__ import annotations

import torch

from ..reference.layout import (
    LANE32_A4_HI,
    LANE32_TS_HI,
    LANE_A0,
    LANE_EVENT_ID,
    LANE_TIMESTAMP,
    NUM_LANES,
    NUM_LANES32,
    PayloadLayout,
    WIDE_LANES,
)
from ..roofline import request_bytes
from . import chunking

#: workflows generated at a time during set-up
GEN_BLOCK = 16384


def narrow32(ev: torch.Tensor) -> torch.Tensor:
    """[.., 18] int64 -> [.., 20] int32 wire32 lanes, exact: the wide
    lanes travel as their low halves in place and their high halves at the
    end. Raises OverflowError if a lane that must fit int32 does not."""
    narrow = [i for i in range(NUM_LANES) if i not in WIDE_LANES]
    part = ev[..., narrow]
    if bool(((part < -(1 << 31)) | (part >= (1 << 31))).any()):
        raise OverflowError("a narrow lane exceeds int32")
    del part
    out = torch.empty(ev.shape[:-1] + (NUM_LANES32,), dtype=torch.int32, device=ev.device)
    out[..., :NUM_LANES] = (((ev & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)
    out[..., LANE32_TS_HI] = (ev[..., LANE_TIMESTAMP] >> 32).to(torch.int32)
    out[..., LANE32_A4_HI] = (ev[..., LANE_A0 + 4] >> 32).to(torch.int32)
    return out


class Resident:
    def __init__(self, cell, seed: int, device: torch.device):
        from cadence_tpu_torch.core.checksum import PayloadLayout as PortLayout

        self.device = device
        self.layout = PortLayout(**cell.config["layout"])
        histories = cell.generator.Histories(cell.config, device)
        self.workflows, self.chunk_rows, self.n_chunks = chunking(cell, histories.block)
        E = histories.template.shape[0]
        self.lanes = torch.empty((self.workflows, E, NUM_LANES32), dtype=torch.int32,
                                 device=device)
        real = torch.empty((self.workflows,), dtype=torch.int64, device=device)
        for lo in range(0, self.workflows, GEN_BLOCK):
            rows = torch.arange(lo, min(lo + GEN_BLOCK, self.workflows), device=device)
            ev = histories(seed, rows)
            real[lo:lo + len(rows)] = (ev[..., LANE_EVENT_ID] > 0).sum(dim=1)
            self.lanes[lo:lo + len(rows)] = narrow32(ev)
            del ev
        self._events = real.view(self.n_chunks, self.chunk_rows).sum(dim=1).tolist()
        layout = PayloadLayout(**cell.config["layout"])
        self._bytes = [request_bytes(n * 4 * NUM_LANES32, self.chunk_rows, layout)
                       for n in self._events]

    def request(self, chunk: int):
        from cadence_tpu_torch.ops import replay

        lo = chunk * self.chunk_rows
        return replay.replay_to_crc32(self.lanes[lo:lo + self.chunk_rows], self.layout,
                                      device=self.device)

    def events(self, chunk: int) -> int:
        return self._events[chunk]

    def bytes(self, chunk: int) -> int:
        return self._bytes[chunk]

    def release(self) -> None:
        del self.lanes


def prepare(cell, seed: int, device: torch.device) -> Resident:
    return Resident(cell, seed, device)
