"""Capacity-escalation ladder: rows whose tables overflow stay on the card.

The kernels' pending tables are fixed at PayloadLayout's K, so a workflow
that at some point holds more than K pending items flags TABLE_OVERFLOW
(or another capacity error, ops/state.CAPACITY_ERRORS). The ladder gathers
those rows into a compact sub-corpus (ops/encode.gather_subcorpus, or
ops/wirec.gather_corpus for compressed lanes) and replays it again with
every capacity doubled, K -> 2K -> 4K up a bounded number of rungs, then
projects the payload back to the BASE width (kernel B's narrow
projection), so a resolved row hashes to exactly what the oracle gives.
Rows that still overflow at the top rung, whose final state does not fit
the base payload, or whose error no capacity can clear, are left for the
oracle: counted, never silent.

Kernel A reads K, B and Kv at run time, so a rung is the same kernels on a
wider state: nothing is compiled per rung. The sub-corpora are still
padded to power-of-two shapes (workflows to at least 8, events to at
least 16), as the JAX package pads them for its compile cache, so the
rows each rung replays and `last_run` are the reference's.

Given a mesh of more than one device (`mesh`, set by the engines that
serve from one), the dense and wirec rungs re-replay under the mesh's
shard axis (parallel/mesh.py replay_sharded_escalated,
replay_wirec_sharded_escalated_crc), the sub-corpus padded to a multiple
of the mesh size; the rungs that keep their widened states
(escalate_states) stay on the ladder's own device, as in the JAX package,
and the resident rungs (escalate_resident) run where the pre-append
states live.

Counters land under `tpu.fallback` (flagged rows, rows per rung, resolved
and residual rows) and each rung's seconds under its `fallback` series.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout
from ..device import resolve_device
from ..ops.encode import gather_subcorpus
from ..ops.replay import replay_escalated, replay_escalated_state, replay_wirec_escalated_crc
from ..ops.state import CAPACITY_ERRORS, widen_layout
from ..ops.wirec import gather_corpus
from ..parallel.mesh import replay_sharded_escalated, replay_wirec_sharded_escalated_crc
from ..utils import metrics as m

#: rungs above base capacity (K -> 2K -> 4K with the default 2)
RUNGS_ENV = "CADENCE_TPU_LADDER_RUNGS"
DEFAULT_RUNGS = 2

_CAPACITY = np.asarray(CAPACITY_ERRORS, dtype=np.int32)


def _pow2(n: int, floor: int) -> int:
    return max(floor, 1 << (max(1, int(n)) - 1).bit_length())


@dataclass
class PendingEscalation:
    """One chunk's launched rung-1 replay (submit() -> finish())."""

    sub: np.ndarray   # trimmed [F, E, L] sub-corpus (host copy)
    outs: tuple       # rung-1 device tensors (rows, err, ovf, branch)
    count: int        # real rows (padding excluded)


@dataclass
class LadderOutcome:
    """Final arbitration-ready results for F flagged rows."""

    rows: np.ndarray       # [F, base_width] (valid where resolved)
    resolved: np.ndarray   # [F] bool: resolved on the card at some rung
    errors: np.ndarray     # [F] int32: the last rung's error per row
    branch: np.ndarray     # [F] int32: the card's current branch
    rungs: List[dict] = field(default_factory=list)  # per-rung accounting


class EscalationLadder:
    """Widened-K re-replay ladder over capacity-flagged rows, on `device`
    (None: the card)."""

    def __init__(self, layout: PayloadLayout = DEFAULT_LAYOUT,
                 max_rungs: Optional[int] = None, registry=None, device=None,
                 mesh=None) -> None:
        self.layout = layout
        self.max_rungs = (max_rungs if max_rungs is not None
                          else int(os.environ.get(RUNGS_ENV, str(DEFAULT_RUNGS))))
        self.max_rungs = max(1, self.max_rungs)
        self.metrics = registry if registry is not None else m.DEFAULT_REGISTRY
        self.device = resolve_device(device)
        #: when set, the dense and wirec rungs re-replay sharded over the
        #: mesh instead of on `device`
        self.mesh = mesh
        #: per-rung accounting of the most recent escalate/finish call
        self.last_run: List[dict] = []

    # -- shared mechanics ---------------------------------------------------

    def rung_layout(self, rung: int) -> PayloadLayout:
        return widen_layout(self.layout, 2 ** rung)

    def _pad_dims(self, F: int, E: int) -> Tuple[int, int]:
        """The power-of-two padded shape of a rung's sub-corpus; the
        workflow axis also rounds up to a multiple of the mesh, so every
        shard gets a whole slice."""
        Wp = _pow2(F, 8)
        n = self.mesh.size if self.mesh is not None else 0
        if n > 1 and Wp % n:
            Wp = -(-Wp // n) * n
        return Wp, _pow2(E, 16)

    @staticmethod
    def capacity_flagged(errors: np.ndarray) -> np.ndarray:
        """Local indices of rows whose error a wider K could clear."""
        return np.nonzero(np.isin(np.asarray(errors), _CAPACITY))[0]

    def _record_rung(self, rung: int, rows: int, seconds: float) -> None:
        self.metrics.inc(m.SCOPE_TPU_FALLBACK, m.ladder_rung_rows(rung), rows)
        self.metrics.observe(m.SCOPE_TPU_FALLBACK, m.M_PROFILE_FALLBACK, seconds)
        self.last_run.append({"rung": rung, "rows": rows, "seconds": round(seconds, 6)})

    def _finalize(self, resolved: np.ndarray) -> None:
        n_res = int(resolved.sum())
        self.metrics.inc(m.SCOPE_TPU_FALLBACK, m.M_LADDER_RESOLVED, n_res)
        self.metrics.inc(m.SCOPE_TPU_FALLBACK, m.M_LADDER_RESIDUAL, len(resolved) - n_res)

    def _pad_dense(self, sub: np.ndarray) -> np.ndarray:
        F, E = sub.shape[:2]
        Wp, Ep = self._pad_dims(F, E)
        return gather_subcorpus(sub, np.arange(F), Wp, Ep)

    def _rung(self, rung: int, padded: np.ndarray):
        if self.mesh is not None:
            return replay_sharded_escalated(padded, self.mesh, self.rung_layout(rung), self.layout)
        return replay_escalated(padded, self.rung_layout(rung), self.layout, self.device)

    # -- dense-lane path ----------------------------------------------------

    def submit(self, sub: np.ndarray) -> PendingEscalation:
        """Launch the rung-1 replay of a trimmed [F, E, L] flagged
        sub-corpus; on the card the launches return before the kernels
        finish, and finish() reads the results back."""
        F = sub.shape[0]
        self.metrics.inc(m.SCOPE_TPU_FALLBACK, m.M_LADDER_FLAGGED, F)
        return PendingEscalation(sub=sub, outs=self._rung(1, self._pad_dense(sub)), count=F)

    def finish(self, pending: Sequence[PendingEscalation]) -> List[LadderOutcome]:
        """Collect rung-1 results and run rungs >= 2 once, batched across
        every pending chunk's survivors. Returns one outcome per pending,
        aligned with its submitted rows."""
        outcomes: List[LadderOutcome] = []
        self.last_run = []
        rung1_rows = sum(p.count for p in pending)
        # (chunk index in `pending`, local row index) of rung-1 survivors
        still: List[Tuple[int, int]] = []
        t0 = time.perf_counter()
        for pi, p in enumerate(pending):
            rows, err, ovf, branch = (a.cpu().numpy()[:p.count].copy() for a in p.outs)
            outcomes.append(LadderOutcome(rows=rows, resolved=(err == 0) & ~ovf,
                                          errors=err, branch=branch))
            still.extend((pi, int(j)) for j in self.capacity_flagged(err))
        if rung1_rows:
            self._record_rung(1, rung1_rows, time.perf_counter() - t0)

        for rung in range(2, self.max_rungs + 1):
            if not still:
                break
            t0 = time.perf_counter()
            subs = []
            flat = []
            for pi in sorted({q for q, _ in still}):
                idx = [j for q, j in still if q == pi]
                subs.append(gather_subcorpus(pending[pi].sub, idx))
                flat.extend((pi, j) for j in idx)
            E = max(s.shape[1] for s in subs)
            cur = np.concatenate([gather_subcorpus(s, np.arange(s.shape[0]), 0, E)
                                  for s in subs])
            rows, err, ovf, branch = (a.cpu().numpy()
                                      for a in self._rung(rung, self._pad_dense(cur)))
            next_still = []
            for k, (pi, j) in enumerate(flat):
                outcomes[pi].errors[j] = err[k]
                outcomes[pi].branch[j] = branch[k]
                if err[k] == 0 and not ovf[k]:
                    outcomes[pi].rows[j] = rows[k]
                    outcomes[pi].resolved[j] = True
                elif err[k] in _CAPACITY:
                    next_still.append((pi, j))
            self._record_rung(rung, len(flat), time.perf_counter() - t0)
            still = next_still

        for o in outcomes:
            o.rungs = list(self.last_run)
            self._finalize(o.resolved)
        return outcomes

    def escalate(self, sub: np.ndarray) -> LadderOutcome:
        """Synchronous full ladder over one trimmed sub-corpus."""
        return self.finish([self.submit(sub)])[0]

    # -- full-state path ----------------------------------------------------

    def escalate_states(self, sub: np.ndarray):
        """The ladder that keeps the WIDENED rung states. Returns (outcome,
        states) where states[k] is (the ReplayState of the rung that
        resolved row k, the row's index in it), or None."""
        F = sub.shape[0]
        self.metrics.inc(m.SCOPE_TPU_FALLBACK, m.M_LADDER_FLAGGED, F)
        self.last_run = []
        rows_out = np.zeros((F, self.layout.width), np.int64)
        resolved = np.zeros(F, bool)
        err_out = np.zeros(F, np.int32)
        branch_out = np.zeros(F, np.int32)
        states: List[Optional[tuple]] = [None] * F
        active = np.arange(F)
        cur = sub
        for rung in range(1, self.max_rungs + 1):
            t0 = time.perf_counter()
            s, rows_d, err_d, ovf_d = replay_escalated_state(
                self._pad_dense(cur), self.rung_layout(rung), self.layout, self.device)
            n = len(active)
            rows, err, ovf = (a.cpu().numpy()[:n] for a in (rows_d, err_d, ovf_d))
            branch = s.current_branch.cpu().numpy()[:n]
            self._record_rung(rung, n, time.perf_counter() - t0)
            ok = (err == 0) & ~ovf
            for k in np.nonzero(ok)[0]:
                gi = active[k]
                rows_out[gi] = rows[k]
                resolved[gi] = True
                states[gi] = (s, int(k))
                branch_out[gi] = branch[k]
            err_out[active] = err
            still = self.capacity_flagged(err)
            if not len(still):
                break
            cur = gather_subcorpus(cur, still)
            active = active[still]
        self._finalize(resolved)
        return (LadderOutcome(rows=rows_out, resolved=resolved, errors=err_out,
                              branch=branch_out, rungs=list(self.last_run)), states)

    # -- resident (from-state) path -----------------------------------------

    def escalate_resident(self, sub: np.ndarray, states, base_rung: int = 0):
        """Widened re-replay of an APPEND suffix against carried states.

        `sub` is the trimmed [F, E, L] suffix sub-corpus of rows whose
        from-state append flagged a capacity error; `states` the batched
        PRE-append states those rows replayed from (all at rung
        `base_rung`'s layout). Each rung is one kernel-G launch that widens
        the still-active pre-append states, pads them with init rows to the
        padded shape and gathers the survivors of the rung before, then
        kernel A replays ONLY the suffix and kernel B projects to the base
        width, on the device that holds the states: an escalated append
        stays O(new events).

        Returns (outcome, states_out): outcome aligned with `sub`;
        states_out[k] = (the rung's final state, the row in it, rung) of
        the rung that resolved row k, or None."""
        from ..ops.payload import payload_rows_narrow
        from ..ops.rehome import rehome
        from ..ops.replay import replay_scan
        from ..parallel.mesh import _to_device, on_device

        F = sub.shape[0]
        self.metrics.inc(m.SCOPE_TPU_FALLBACK, m.M_LADDER_FLAGGED, F)
        self.last_run = []
        rows_out = np.zeros((F, self.layout.width), np.int64)
        resolved = np.zeros(F, bool)
        err_out = np.zeros(F, np.int32)
        branch_out = np.zeros(F, np.int32)
        states_out: List[Optional[tuple]] = [None] * F
        active = np.arange(F)
        #: the rows of `states` still active (the survivors' pre-append states)
        local = np.arange(F)
        cur = sub
        dev = states.state.device
        for rung in range(base_rung + 1, self.max_rungs + 1):
            t0 = time.perf_counter()
            padded = self._pad_dense(cur)
            n = len(active)
            with on_device(dev):
                s = rehome(states, list(local) + [-1] * (padded.shape[0] - n),
                           self.rung_layout(rung))
                replay_scan(s, _to_device(padded, dev))
                rows_d, ovf_d = payload_rows_narrow(s, self.layout)
            rows, err, ovf, branch = (a[:n].cpu().numpy()
                                      for a in (rows_d, s.error, ovf_d, s.current_branch))
            self._record_rung(rung, n, time.perf_counter() - t0)
            ok = (err == 0) & ~ovf
            for k in np.nonzero(ok)[0]:
                gi = active[k]
                rows_out[gi] = rows[k]
                resolved[gi] = True
                branch_out[gi] = branch[k]
                states_out[gi] = (s, int(k), rung)
            err_out[active] = err
            still = self.capacity_flagged(err)
            if not len(still):
                break
            cur = gather_subcorpus(cur, still)
            local = local[still]
            active = active[still]
        self._finalize(resolved)
        return (LadderOutcome(rows=rows_out, resolved=resolved, errors=err_out,
                              branch=branch_out, rungs=list(self.last_run)), states_out)

    # -- wirec path ---------------------------------------------------------

    def escalate_wirec(self, corpus, indices) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full ladder over flagged rows of a wirec corpus, reduced on the
        card to base-width CRC32s. Returns (crc32 [F] uint32, resolved [F]
        bool, errors [F] int32) aligned with `indices`."""
        idx = np.asarray(indices, dtype=np.int64)
        F = len(idx)
        self.metrics.inc(m.SCOPE_TPU_FALLBACK, m.M_LADDER_FLAGGED, F)
        self.last_run = []
        crcs_out = np.zeros(F, np.uint32)
        resolved = np.zeros(F, bool)
        err_out = np.zeros(F, np.int32)
        active = np.arange(F)
        cur = gather_corpus(corpus, idx)
        for rung in range(1, self.max_rungs + 1):
            t0 = time.perf_counter()
            n = len(active)
            Wp, Ep = self._pad_dims(n, cur.slab.shape[1])
            padded = gather_corpus(cur, np.arange(n), Wp, Ep)
            if self.mesh is not None:
                outs = replay_wirec_sharded_escalated_crc(padded, self.mesh,
                                                          self.rung_layout(rung), self.layout)
            else:
                outs = replay_wirec_escalated_crc(padded.slab, padded.bases, padded.n_events,
                                                  padded.profile, self.rung_layout(rung),
                                                  self.layout, self.device)
            crc, err, ovf = (a.cpu().numpy()[:n] for a in outs)
            self._record_rung(rung, n, time.perf_counter() - t0)
            ok = (err == 0) & ~ovf
            crcs_out[active[ok]] = crc[ok].astype(np.uint32)
            resolved[active[ok]] = True
            err_out[active] = err
            still = self.capacity_flagged(err)
            if not len(still):
                break
            cur = gather_corpus(cur, still)
            active = active[still]
        self._finalize(resolved)
        return crcs_out, resolved, err_out
