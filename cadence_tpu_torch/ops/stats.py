"""The mesh's per-shard statistics: workflows with an error, workflows closed.

The JAX package's sharded replays (parallel/mesh.py) end each shard with
stack([(error != 0).sum(), (close_status != 0).sum()]) and let XLA sum
the [2] across the mesh. Here each shard computes its [2] int64 on its
own device, with kernel F (csrc/stats.cu) for tensors on the GPU and the
plain PyTorch version `stats_plain` for tensors on the CPU, and the host
sums the shards' counts (parallel/mesh.py).
"""
from __future__ import annotations

import torch

from . import _build


def stats_plain(error: torch.Tensor, close_status: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel F: [2] int64 = [rows with an
    error, rows closed]."""
    return torch.stack([(error != 0).sum(), (close_status != 0).sum()]).to(torch.int64)


def stats(error: torch.Tensor, close_status: torch.Tensor) -> torch.Tensor:
    """[2] int64 [rows with an error, rows closed] of one shard: kernel F
    on the GPU, the plain version on the CPU."""
    if error.device != close_status.device:
        raise ValueError(f"stats: error on {error.device}, close_status on "
                         f"{close_status.device}")
    if error.device.type == "cpu":
        return stats_plain(error, close_status)
    if error.device.type != "cuda":
        raise ValueError(f"stats: unsupported device {error.device}")
    launch, out = stats_launch(error, close_status)
    launch()
    return out


def stats_launch(error: torch.Tensor, close_status: torch.Tensor):
    """Check what kernel F takes; return (its launch, the [2] int64 output
    it zeroes and writes)."""
    if error.dim() != 1:
        raise ValueError(f"stats: expected [W] tensors, got {tuple(error.shape)}")
    W = error.shape[0]
    _build.require(error, torch.int32, (W,), "stats error")
    _build.require(close_status, torch.int32, (W,), "stats close_status", error.device)
    out = torch.empty((2,), dtype=torch.int64, device=error.device)
    return _build.launcher("stats", _build.load().cadence_stats, error, close_status, out, W,
                           _build.stream_of(error)), out
