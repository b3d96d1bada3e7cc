"""Chunked event streaming: replay histories longer than device memory.

Replay is sequential per workflow, so a long history is cut on the event
axis and the state carries from chunk to chunk: the device holds one
state and at most two event chunks, whatever the history's length.

The JAX package donates the carried state to each chunk step and relies
on async dispatch to overlap the host's packing of chunk N+1 with the
device's replay of chunk N. Here kernel A (ops/replay.replay_scan)
already updates the state in place, and the overlap is explicit: two
page-locked host buffers of the chunk shape, a side copy stream that
stages chunk N+1 while kernel A runs chunk N on the current stream, an
event after each copy that the kernel waits for, and an event after each
kernel that the host waits for before it writes into the buffer that
kernel read.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout
from ..device import resolve_device
from .payload import payload_rows
from .replay import replay_scan
from .state import ReplayState, init_state


def _replay_chunk(s: ReplayState, events: torch.Tensor) -> ReplayState:
    """Apply one [W, E_chunk, L] chunk to the carried state, in place."""
    return replay_scan(s, events)


class StreamingReplayer:
    """Feed event chunks for W workflows; the state carries across chunks,
    on `device` (None: the card).

    Chunks may split histories at any event boundary (batch bookkeeping
    lanes travel with each event). Padding rows (event id 0) are no-ops,
    so ragged chunking across workflows is fine.
    """

    def __init__(self, num_workflows: int, layout: PayloadLayout = DEFAULT_LAYOUT,
                 device=None) -> None:
        self.layout = layout
        self.num_workflows = num_workflows
        self.device = resolve_device(device)
        self.state: ReplayState = init_state(num_workflows, layout, self.device)
        self._copy_stream: Optional[torch.cuda.Stream] = None
        #: per ring slot: page-locked host buffer, device buffer, and the
        #: event recorded after the kernel that last read the slot
        self._host: List[Optional[torch.Tensor]] = [None, None]
        self._dev: List[Optional[torch.Tensor]] = [None, None]
        self._read: List[Optional[torch.cuda.Event]] = [None, None]
        self._slot = 0

    def feed(self, chunk: np.ndarray) -> None:
        """Stage a [W, E_chunk, L] chunk and queue its replay; on the card
        this returns once the copy and the kernel are queued, so the caller
        can pack the next chunk while they run."""
        chunk = np.ascontiguousarray(chunk)
        if chunk.shape[0] != self.num_workflows:
            raise ValueError(f"chunk holds {chunk.shape[0]} workflows, the replayer "
                             f"{self.num_workflows}")
        if self.device.type == "cpu":
            _replay_chunk(self.state, torch.from_numpy(chunk))
            return
        with torch.cuda.device(self.device):
            self._feed_cuda(chunk)

    def _feed_cuda(self, chunk: np.ndarray) -> None:
        i = self._slot
        self._slot ^= 1
        if self._read[i] is not None:
            self._read[i].synchronize()  # the kernel that read slot i has finished
        src = torch.from_numpy(chunk)
        host = self._host[i]
        if host is None or host.shape != src.shape or host.dtype != src.dtype:
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self._host[i] = host
            self._dev[i] = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        host.copy_(src)
        compute = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            self._dev[i].copy_(host, non_blocking=True)
        compute.wait_event(self._copy_stream.record_event())
        _replay_chunk(self.state, self._dev[i])
        self._read[i] = compute.record_event()

    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """(payload rows, errors) as numpy, after every fed chunk."""
        cuda = self.device.type == "cuda"
        with torch.cuda.device(self.device) if cuda else contextlib.nullcontext():
            rows = payload_rows(self.state, self.layout)
            return rows.cpu().numpy(), self.state.error.cpu().numpy()


def replay_streamed(events: np.ndarray, chunk_events: int,
                    layout: PayloadLayout = DEFAULT_LAYOUT,
                    device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Replay a full [W, E, L] tensor in chunks of `chunk_events` events;
    the tail chunk is padded to the steady shape with no-op rows (event id
    0, type -1), as the JAX package pads it."""
    replayer = StreamingReplayer(events.shape[0], layout, device)
    for start in range(0, events.shape[1], chunk_events):
        chunk = events[:, start:start + chunk_events]
        if chunk.shape[1] < chunk_events:
            pad = np.zeros((chunk.shape[0], chunk_events - chunk.shape[1], chunk.shape[2]),
                           dtype=chunk.dtype)
            pad[:, :, 1] = -1  # LANE_EVENT_TYPE padding marker
            chunk = np.concatenate([chunk, pad], axis=1)
        replayer.feed(chunk)
    return replayer.finish()
