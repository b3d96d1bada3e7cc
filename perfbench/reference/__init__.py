"""The plain reference the benchmark judges the port with.

A frozen copy of the port's plain replay (transitions.py, state.py),
payload (payload.py) and lane layout (layout.py), with CRC32 by zlib. It
imports torch, numpy and the standard library only: nothing of the
program it judges and nothing of the JAX package. It works out, from the
int64 event lanes the benchmark made, what the port derives on the card:
the final state, the payload row and its CRC32, and the error flags.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .layout import DEFAULT_LAYOUT, PayloadLayout
from .payload import crc32_of_rows, payload_rows
from .state import init_state
from .transitions import step


def replay_rows(lanes: torch.Tensor, layout: PayloadLayout = DEFAULT_LAYOUT
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(payload rows [W, width] int64, error [W] int32) of int64 lanes
    [W, E, 18], replayed on their own device one plain step an event."""
    s = init_state(lanes.shape[0], layout, lanes.device)
    for e in range(lanes.shape[1]):
        s = step(s, lanes[:, e])
    return payload_rows(s, layout).cpu().numpy(), s.error.cpu().numpy().astype(np.int32)


def replay_crc(lanes: torch.Tensor, layout: PayloadLayout = DEFAULT_LAYOUT,
               word_bytes: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(crc32 [W] uint32, error [W] int32) of int64 lanes [W, E, 18];
    `word_bytes=4` is the control's payload narrowed to int32 words."""
    rows, error = replay_rows(lanes, layout)
    return crc32_of_rows(rows, word_bytes), error
