"""Kernel B (csrc/payload.cu) with its fit and counts epilogues on the card,
against its plain version.

These tests need the card (marker `cuda`) and skip without one. They
import nothing of JAX or of the JAX package; on a machine with a card run
them without the conftest, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_payload_card.py -q

The states are trap_corpus's carried states replayed by kernel A at x1,
x2, x4 and x8 (full tables, forks, sticky errors, a history at Kv),
projected to the base layout and to their own, at widths that leave
blocks partial; every output must equal payload_rows_narrow_plain's,
exactly.
"""
import pytest
import torch

from cadence_tpu_torch.core.checksum import DEFAULT_LAYOUT
from cadence_tpu_torch.gen.lanes import trap_corpus
from cadence_tpu_torch.ops import payload as P
from cadence_tpu_torch.ops.convert import state_from_numpy
from cadence_tpu_torch.ops.replay import replay_scan
from cadence_tpu_torch.ops.state import map_state, widen_layout

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(factor: int, W: int, dev):
    """trap_corpus's 384 states at x`factor` replayed on the card, their
    rows repeated (or cut) to W."""
    lay = widen_layout(DEFAULT_LAYOUT, factor)
    st, ln = trap_corpus(384, 24, 950 + factor, lay)
    s = replay_scan(state_from_numpy(st, dev), torch.from_numpy(ln).to(dev))
    rows = torch.arange(W, device=dev) % 384
    return map_state(lambda t: t.index_select(0, rows).contiguous(), s)


@pytest.mark.parametrize("factor", [1, 2, 4, 8])
@pytest.mark.parametrize("W", [1, 8, 33, 64, 4096])
def test_epilogues_equal_the_plain_version(factor, W):
    dev = _card()
    s = _state(factor, W, dev)
    for out in {DEFAULT_LAYOUT, widen_layout(DEFAULT_LAYOUT, factor)}:
        want = P.payload_rows_narrow_plain(s, out, fit=True, counts=True)
        for fit, counts in ((False, False), (True, False), (False, True), (True, True)):
            got = P.payload_rows_narrow(s, out, fit=fit, counts=counts)
            torch.cuda.synchronize()
            keep = (True, True, fit, counts)
            for g, w in zip(got, [w for w, k in zip(want, keep) if k]):
                assert torch.equal(g, w), (factor, W, out.width, fit, counts)


def test_counts_leave_their_scratch_at_zero():
    """Launches back to back on one stream each give the counts and leave
    the running total and the ticket at 0; W = 0 gives zeros."""
    dev = _card()
    s = _state(2, 4096, dev)
    s.close_status[::3] = 1
    want = P.payload_rows_narrow_plain(s, DEFAULT_LAYOUT, counts=True)[2]
    assert int(want[0]) and int(want[1])
    launch, _rows, _ovf, counts = P.payload_launch(s, DEFAULT_LAYOUT, counts=True)
    for _ in range(3):
        counts.fill_(-1)
        launch()
        torch.cuda.synchronize()
        assert torch.equal(counts, want)
        stream = torch.cuda.current_stream(dev).cuda_stream
        assert P._counts_scratch[(s.state.device, stream)].tolist() == [0, 0]
    empty = _state(1, 0, dev)
    assert P.payload_rows_narrow(empty, DEFAULT_LAYOUT, counts=True)[2].tolist() == [0, 0]
