"""Minimizing shrinker: reduce a parity-failing history to a minimal
failing batch sequence before reporting.

A fuzzed divergence on a 200-event history is unactionable; the same
divergence on 3 batches names the broken transition. The shrinker is
classic ddmin (Zeller's delta debugging) over the BATCH axis — batches
are the transaction-boundary unit both replayers consume
(`apply_batch` / one encoded segment), so any subset is still a
replayable input even when it is no longer a *legal* workflow history:
the failure predicate decides what counts, and the default parity
predicates treat "either side errors" as NOT the failure being chased
(a shrink must preserve the original defect, not trade it for a
different crash).

Reproducibility: a `ShrinkReport` carries the generator coordinates
`(seed, workflow_index, profile, target_events)` plus the KEPT batch
indices and the minimal slice's digest — `reproduce()` regenerates the
exact minimal input from the seed alone, which is what the tests pin.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout
from ..core.events import HistoryBatch
from .fuzz import generate_fuzz_history, history_digest, oracle_final_row

Predicate = Callable[[List[HistoryBatch]], bool]


@dataclass
class ShrinkReport:
    """One shrink outcome, reproducible from the generator coordinates."""

    seed: int
    workflow_index: int
    profile: str
    target_events: int
    kept_indices: List[int] = field(default_factory=list)
    original_batches: int = 0
    original_events: int = 0
    shrunk_batches: int = 0
    shrunk_events: int = 0
    predicate_calls: int = 0
    digest: str = ""
    event_types: List[str] = field(default_factory=list)

    def reproduce(self) -> List[HistoryBatch]:
        """Regenerate the minimal failing slice from the seed alone."""
        full = generate_fuzz_history(self.seed, self.workflow_index,
                                     self.target_events, self.profile)
        return [full[i] for i in self.kept_indices]

    def summary(self) -> dict:
        return {
            "seed": self.seed, "workflow_index": self.workflow_index,
            "profile": self.profile, "target_events": self.target_events,
            "kept_indices": self.kept_indices,
            "batches": f"{self.original_batches} -> {self.shrunk_batches}",
            "events": f"{self.original_events} -> {self.shrunk_events}",
            "predicate_calls": self.predicate_calls,
            "digest": self.digest, "event_types": self.event_types,
        }


def _events_of(batches: Sequence[HistoryBatch]) -> int:
    return sum(len(b.events) + len(b.new_run_events or ())
               for b in batches)


def shrink_batches(batches: List[HistoryBatch], failing: Predicate,
                   max_calls: int = 2000) -> tuple:
    """ddmin over the batch list: returns (minimal_indices, calls).

    Invariant: `failing([batches[i] for i in minimal_indices])` is True,
    and removing ANY single remaining batch makes it False (1-minimal)."""
    calls = 0

    def check(indices: List[int]) -> bool:
        nonlocal calls
        calls += 1
        if calls > max_calls:
            raise RuntimeError(f"shrinker exceeded {max_calls} "
                               "predicate calls")
        return failing([batches[i] for i in indices])

    if not check(list(range(len(batches)))):
        raise ValueError("shrink_batches called with a non-failing input")
    indices = list(range(len(batches)))
    n = 2
    while len(indices) >= 2:
        chunk = max(1, len(indices) // n)
        subsets = [indices[i:i + chunk]
                   for i in range(0, len(indices), chunk)]
        reduced = False
        # try each subset alone, then each complement
        for sub in subsets:
            if len(sub) < len(indices) and check(sub):
                indices, n, reduced = sub, 2, True
                break
        if not reduced:
            for sub in subsets:
                comp = [i for i in indices if i not in sub]
                if comp and len(comp) < len(indices) and check(comp):
                    indices, n, reduced = comp, max(2, n - 1), True
                    break
        if not reduced:
            if n >= len(indices):
                break
            n = min(len(indices), n * 2)
    # 1-minimality sweep: ddmin at full granularity can still keep a
    # batch whose removal alone preserves the failure
    changed = True
    while changed and len(indices) > 1:
        changed = False
        for i in list(indices):
            trial = [j for j in indices if j != i]
            if check(trial):
                indices = trial
                changed = True
                break
    return indices, calls


def shrink_history(seed: int, workflow_index: int, failing: Predicate,
                   target_events: int = 100, profile: str = "mixed",
                   max_calls: int = 2000) -> ShrinkReport:
    """Shrink one generated history against `failing`; the report's
    coordinates alone reproduce the minimal slice."""
    batches = generate_fuzz_history(seed, workflow_index, target_events,
                                    profile)
    kept, calls = shrink_batches(batches, failing, max_calls=max_calls)
    minimal = [batches[i] for i in kept]
    from ..core.enums import EventType
    return ShrinkReport(
        seed=seed, workflow_index=workflow_index, profile=profile,
        target_events=target_events, kept_indices=kept,
        original_batches=len(batches), original_events=_events_of(batches),
        shrunk_batches=len(minimal), shrunk_events=_events_of(minimal),
        predicate_calls=calls, digest=history_digest(minimal),
        event_types=sorted({EventType(e.event_type).name
                            for b in minimal for e in b.events}))


# ---------------------------------------------------------------------------
# Parity predicates
# ---------------------------------------------------------------------------


def _device_row(batches: List[HistoryBatch], layout: PayloadLayout,
                device=None) -> Optional[np.ndarray]:
    """One history's device payload row, replayed on `device` (None: the
    card), or None when the kernel flags an error (capacity overflow,
    corrupt shape — not the divergence being chased)."""
    from ..ops.replay import replay_corpus

    rows, _crcs, errors = replay_corpus([batches], layout, device=device)
    if int(errors[0]) != 0:
        return None
    return rows[0]


def parity_predicate(layout: PayloadLayout = DEFAULT_LAYOUT,
                     device=None) -> Predicate:
    """True iff oracle and device (`device`; None: the card) BOTH replay
    the slice cleanly and their payload rows differ — the real
    divergence-chasing predicate, for reported failures."""

    def failing(batches: List[HistoryBatch]) -> bool:
        if not batches:
            return False
        try:
            expected = oracle_final_row(batches, layout)
        except Exception:
            return False  # oracle rejects the slice: different failure
        got = _device_row(batches, layout, device)
        return got is not None and not (got == expected).all()

    return failing


def poisoned_parity_predicate(poison_signal: str,
                              layout: PayloadLayout = DEFAULT_LAYOUT,
                              device=None) -> Predicate:
    """The injected-divergence harness: behaves exactly like
    `parity_predicate`, except the device row is bit-flipped whenever
    the slice still contains a signal named `poison_signal` — a
    deterministic stand-in for "the kernel mishandles this one event",
    letting shrinker tests run the REAL reduction loop against a known
    minimal witness (the batch carrying the poisoned signal)."""
    base_layout = layout

    def failing(batches: List[HistoryBatch]) -> bool:
        if not batches:
            return False
        poisoned = any(
            e.get("signal_name") == poison_signal
            for b in batches
            for group in (b.events, b.new_run_events or ())
            for e in group)
        if not poisoned:
            return False
        try:
            expected = oracle_final_row(batches, base_layout)
        except Exception:
            return False
        got = _device_row(batches, base_layout, device)
        if got is None:
            return False
        got = got.copy()
        got[0] ^= 1  # the injected device-side defect
        return not (got == expected).all()

    return failing


def inject_poison_signal(seed: int, workflow_index: int,
                         target_events: int = 100,
                         profile: str = "mixed") -> Optional[str]:
    """Pick the LAST generated signal name of a history as the poison
    (deterministic per seed); None when the walk emitted no signals."""
    batches = generate_fuzz_history(seed, workflow_index, target_events,
                                    profile)
    from ..core.enums import EventType
    names = [e.get("signal_name")
             for b in batches for e in b.events
             if e.event_type == EventType.WorkflowExecutionSignaled
             and e.get("signal_name")]
    return names[-1] if names else None
