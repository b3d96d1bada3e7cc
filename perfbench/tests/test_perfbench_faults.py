"""The check fails a run whose timed path is broken underneath, and the
control (the reference without each history's last event) fails where
the program passes. One card: no exchange between chips to leave out."""
import numpy as np
import pytest
import torch

from perfbench.catalog import find_cell

from .conftest import TINY, run_tiny


def _leave_rows_unreplayed(scan):
    """`scan` that replays only the first half of the workflows."""
    from cadence_tpu_torch.ops.state import leaves, map_state

    def half(s, *inputs, **kw):
        h = s.state.shape[0] // 2
        part = map_state(lambda t: t[:h].clone(), s)
        scan(part, *[x[:h].contiguous() if torch.is_tensor(x) and x.dim() and
                     x.shape[0] == s.state.shape[0] else x for x in inputs], **kw)
        for (_, dst), (_, src) in zip(leaves(s), leaves(part)):
            dst[:h].copy_(src)
        return s
    return half


def _fault(name, monkeypatch, entry):
    from cadence_tpu_torch.ops import replay

    if name == "state_unchanged":
        monkeypatch.setattr(replay, "replay_scan", lambda s, *a, **k: s)
        monkeypatch.setattr(replay, "wirec_scan", lambda s, *a, **k: s)
    elif name == "half_the_batch":
        monkeypatch.setattr(replay, "replay_scan", _leave_rows_unreplayed(replay.replay_scan))
        monkeypatch.setattr(replay, "wirec_scan", _leave_rows_unreplayed(replay.wirec_scan))
    elif name == "answer_altered":
        crc = replay.crc32_rows
        monkeypatch.setattr(replay, "crc32_rows", lambda rows: crc(rows) ^ (
            torch.arange(rows.shape[0]) % 7 == 3).to(torch.int64))
    elif name == "wrong_chunk":
        request = entry.Resident.request
        monkeypatch.setattr(entry.Resident, "request",
                            lambda self, chunk: request(self, (chunk + 1) % self.n_chunks))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered",
                                   "wrong_chunk"])
def test_a_broken_timed_path_is_not_correct(tiny, fault, monkeypatch):
    cell = find_cell(TINY, tiny)
    _fault(fault, monkeypatch, cell.entry)
    result, _ = run_tiny(tiny, cell=cell)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert result["checks"]["answer_mismatch"]["value"] > 0


def test_the_control_fails_where_the_program_passes(tiny):
    from perfbench.control import readings

    got = readings(find_cell(TINY, tiny), 2**32 + 3, 2, torch.device("cpu"))
    assert got["program"]["crc_mismatch"] == 0 and got["program"]["error_mismatch"] == 0
    assert got["control"]["answer_mismatch"] == got["control"]["answers"] == 128
    assert got["int32_lanes"]["answer_mismatch"] == 0
    assert got["distinct_crcs"] >= 5
    assert np.isfinite(got["reference_s"])
