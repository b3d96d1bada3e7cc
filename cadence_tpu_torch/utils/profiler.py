"""Replay profiler: per-launch leg timing into metric histograms.

One end-to-end rate cannot say where a regression went; the legs of a
launch can. The port's instrumented replay paths (engine/executor.py and
engine/rebuild.py) wrap their phases in a ReplayProfiler:

  pack            — host encode/pack of the event corpus
  pack-queue-wait — device consumer stalled waiting on the pack producer
                    pipeline (engine/executor.py): this leg growing means
                    host packing is starving the device; near zero means
                    the device side is the bottleneck
  h2d             — host-to-device transfer (+ bytes, M_H2D_BYTES)
  kernel          — device replay compute, measured to its synchronisation
  readback        — device-to-host pull of payload rows, states, CRCs
  fallback        — capacity-escalation ladder (engine/ladder.py): gather
                    + widened-K re-replay of overflow-flagged rows
  serving         — the serving tier's flush (a later slice of the port)

Legs land as histograms under the component's scope (SCOPE_TPU_REPLAY by
default, SCOPE_REBUILD for the rebuilder). A copy of the JAX package's
utils/profiler.py.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

from . import metrics as m

#: the leg metric names, in pipeline order
LEGS = (m.M_PROFILE_PACK, m.M_PROFILE_PACK_WAIT, m.M_PROFILE_H2D,
        m.M_PROFILE_KERNEL, m.M_PROFILE_READBACK, m.M_PROFILE_FALLBACK,
        m.M_PROFILE_SERVING)


class ReplayProfiler:
    """Cheap handle over a registry: construct per launch site, record
    legs; summary() aggregates whatever the registry has accumulated."""

    def __init__(self, registry: Optional[m.MetricsRegistry] = None,
                 scope: str = m.SCOPE_TPU_REPLAY) -> None:
        self.registry = registry if registry is not None else m.DEFAULT_REGISTRY
        self.scope = scope

    @contextmanager
    def leg(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.registry.observe(self.scope, name,
                                  time.perf_counter() - t0)

    def observe(self, name: str, seconds: float) -> None:
        self.registry.observe(self.scope, name, seconds)

    def h2d(self, nbytes: int) -> None:
        """One host→device transfer of `nbytes` (count + size histogram)."""
        self.registry.inc(self.scope, m.M_H2D_BYTES, int(nbytes))
        self.registry.observe(self.scope, m.M_H2D_BYTES + "-per-transfer",
                              float(nbytes), buckets=m.BYTE_BUCKETS)

    def summary(self) -> Dict[str, object]:
        """Leg breakdown for reports (the bench JSON / `admin profile`)."""
        out: Dict[str, object] = {
            "scope": self.scope,
            "kernel_launches": self.registry.counter(
                self.scope, m.M_KERNEL_LAUNCHES),
            "h2d_bytes": self.registry.counter(self.scope, m.M_H2D_BYTES),
        }
        for leg in LEGS:
            hist = self.registry.histogram(self.scope, leg)
            if hist.count == 0:
                continue
            out[leg] = {
                "count": hist.count,
                "total_s": round(hist.total, 6),
                "p50_s": round(hist.percentile(0.5), 6),
                "p99_s": round(hist.percentile(0.99), 6),
            }
        return out
