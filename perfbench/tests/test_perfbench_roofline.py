"""Kernel A's bytes, counted from shapes."""
import pytest

from perfbench.reference.layout import DEFAULT_LAYOUT, PayloadLayout
from perfbench.roofline import (
    PEAK_BYTES_PER_S,
    request_bytes,
    roofline_pct,
    state_bytes_per_workflow,
)


def test_state_bytes_are_the_ports_state_tensors():
    from cadence_tpu_torch.core.checksum import PayloadLayout as PortLayout
    from cadence_tpu_torch.ops.state import init_state, leaves

    for layout in (DEFAULT_LAYOUT, PayloadLayout(max_activities=64, max_branches=4)):
        s = init_state(3, PortLayout(**layout.__dict__), "meta")
        assert state_bytes_per_workflow(layout) * 3 == sum(
            t.numel() * t.element_size() for _, t in leaves(s))
    assert state_bytes_per_workflow(DEFAULT_LAYOUT) == 3602


def test_request_bytes_and_the_share():
    per_state = state_bytes_per_workflow(DEFAULT_LAYOUT)
    assert request_bytes(16384 * 1001 * 80, 16384, DEFAULT_LAYOUT) == \
        16384 * 1001 * 80 + 16384 * per_state
    assert roofline_pct(PEAK_BYTES_PER_S * 1e-3, 2e-3) == pytest.approx(50.0)
    assert roofline_pct(1e9, 0.0) is None


def test_the_entries_count_their_inputs_from_shapes(tiny):
    import torch

    from perfbench.catalog import find_cell

    from .conftest import TINY

    cell = find_cell(TINY, tiny)
    resident = cell.entry.prepare(cell, 5, torch.device("cpu"))
    per_state = state_bytes_per_workflow(DEFAULT_LAYOUT)
    cuts = cell.generator.Histories(cell.config, torch.device("cpu")).cuts
    real = int(cuts.sum()) * (resident.chunk_rows // len(cuts))  # every chunk's events
    for chunk in range(resident.n_chunks):
        if cell.mix["entry"] == "wire32":
            inputs = real * 80
        else:
            slab, bases, n_events, _ = resident.chunks[chunk]
            inputs = sum(t.numel() * t.element_size() for t in (slab, bases, n_events))
        assert resident.bytes(chunk) == inputs + resident.chunk_rows * per_state
        assert resident.events(chunk) == real
