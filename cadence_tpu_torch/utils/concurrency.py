"""Host pack-thread resolution: ONE knob for every host-side packer.

Before this module each pack stage picked its own default thread count —
the C++ blob packer capped at cpu_count, `ops/wirec.pack_wirec` defaulted
to serial, the feeder divided cores by pipeline depth, bench took raw
cpu_count — so tuning host packing meant chasing four call sites. Every
stage now resolves through `pack_threads`: explicit argument first, then
the `CADENCE_TPU_PACK_THREADS` env knob, then cpu_count. Callers that
fan out over a bounded work list pass `cap` so a 4-blob chunk never
spawns 64 threads.
"""
from __future__ import annotations

import os
from typing import Optional

#: the one host-packing thread knob (native packer, wirec encoder,
#: feeder, executor, bench all resolve through it)
PACK_THREADS_ENV = "CADENCE_TPU_PACK_THREADS"


def pack_threads(explicit: Optional[int] = None,
                 cap: Optional[int] = None) -> int:
    """Resolve the pack-thread count: explicit arg > env > cpu_count,
    clamped to [1, cap]."""
    if explicit is not None:
        n = int(explicit)
    else:
        env = os.environ.get(PACK_THREADS_ENV, "")
        n = int(env) if env else (os.cpu_count() or 1)
    if cap is not None:
        n = min(n, int(cap))
    return max(1, n)
