"""On a card: the tiny cell through the kernels, correct, with its trace."""
import pytest
import torch

from .conftest import run_tiny


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = run_tiny(tiny, trace=True, device="cuda")
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert {"launches_per_request", "replay_roofline", "hash_ms_per_gevent",
            "device_idle_pct"} <= set(result["metrics"])
