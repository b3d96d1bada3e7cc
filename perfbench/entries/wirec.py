"""The resident wirec corpus, replayed by `ops/replay.py replay_wirec_to_crc`.

Set-up makes the whole corpus's int64 lanes on the device, a chunk at a time,
and packs each chunk on the host with the port's own encoder
(`native/wirec.py pack_wirec_auto`: the native one where it builds),
which measures the chunk's profile; the slab, bases and counts then live
on the device. wirec is the port's storage form, so the pack is set-up's
work. A request hands the port one chunk's slab, bases, counts and
profile; the port makes a fresh state and runs kernel A's wirec reader,
which decodes each event inside its loop, then kernels B and C.
"""
from __future__ import annotations

import torch

from ..reference.layout import PayloadLayout
from ..roofline import request_bytes
from . import chunking


class Resident:
    def __init__(self, cell, seed: int, device: torch.device):
        from cadence_tpu_torch.core.checksum import PayloadLayout as PortLayout
        from cadence_tpu_torch.native.wirec import pack_wirec_auto

        self.device = device
        self.layout = PortLayout(**cell.config["layout"])
        histories = cell.generator.Histories(cell.config, device)
        self.workflows, self.chunk_rows, self.n_chunks = chunking(cell, histories.block)
        ref_layout = PayloadLayout(**cell.config["layout"])
        self.chunks, self._events, self._bytes = [], [], []
        for c in range(self.n_chunks):
            lo = c * self.chunk_rows
            rows = torch.arange(lo, lo + self.chunk_rows, device=device)
            corpus = pack_wirec_auto(histories(seed, rows).cpu().numpy())
            slab, bases, n_events = (torch.from_numpy(a).to(device)
                                     for a in (corpus.slab, corpus.bases, corpus.n_events))
            self.chunks.append((slab, bases, n_events, corpus.profile))
            self._events.append(int(corpus.n_events.sum()))
            packed = corpus.slab.nbytes + corpus.bases.nbytes + corpus.n_events.nbytes
            self._bytes.append(request_bytes(packed, self.chunk_rows, ref_layout))

    def request(self, chunk: int):
        from cadence_tpu_torch.ops import replay

        slab, bases, n_events, profile = self.chunks[chunk]
        return replay.replay_wirec_to_crc(slab, bases, n_events, profile, self.layout,
                                          device=self.device)

    def events(self, chunk: int) -> int:
        return self._events[chunk]

    def bytes(self, chunk: int) -> int:
        return self._bytes[chunk]

    def release(self) -> None:
        self.chunks.clear()


def prepare(cell, seed: int, device: torch.device) -> Resident:
    return Resident(cell, seed, device)
