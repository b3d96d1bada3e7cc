"""The device mesh: workflows partitioned over a list of devices.

The reference scales by hashing workflow IDs onto history shards owned by
hosts. The JAX package makes that axis ("which workflows live where") a
sharded array dimension over a `jax.sharding.Mesh` with one 'shard' axis,
and lets XLA insert the one collective the replay needs, a psum of the
[2] error/closed counts. Here a `Mesh` is a tuple of `torch.device`s. A
corpus's workflow axis splits into `mesh.size` equal slices, each slice
is copied to its device from page-locked memory, each shard runs its own
launches on its own device (kernel A, B, C where the path hashes, and
kernel F for the counts), and the host sums the shards' [2] counts: 16
bytes read back per shard, no NCCL.

A mesh may list one device more than once: the CPU tests model n shards
as n slices of the CPU, and chip_smoke.py as n slices of one card. On
several cards each shard's launches run under that shard's device (the
kernels go through one ctypes library, which launches on the current
CUDA device) and on its current stream; the results are gathered onto
the mesh's first device in workflow order.
"""
from __future__ import annotations

import contextlib
import os
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.checksum import DEFAULT_LAYOUT, PayloadLayout
from ..device import canonical_device, resolve_device
from ..ops.crc import crc32_rows
from ..ops.payload import payload_rows
from ..ops.replay import (replay_escalated, replay_events, replay_events32, replay_wirec,
                          replay_wirec_escalated_crc)
from ..ops.stats import stats
from ..ops.wirec import WirecCorpus

SHARD_AXIS = "shard"

#: serving-mesh width knob: how many devices the serving hot path
#: (engine/executor.py, verify, rebuild) shards across. Unset/1 = one
#: device; 0 or "all" = every visible device; n = the first n.
MESH_DEVICES_ENV = "CADENCE_TPU_MESH_DEVICES"


class Mesh:
    """A 1-D mesh: the devices the 'shard' axis partitions the workflow
    axis over, in mesh order. Devices are kept as their tensors name them
    (device.canonical_device): "cuda" becomes the current card's index."""

    def __init__(self, devices: Sequence) -> None:
        self.devices: Tuple[torch.device, ...] = tuple(canonical_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the given devices, or every CUDA device (raises when
    there is none, as resolve_device does)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def mesh_devices_requested() -> int:
    """Parse the CADENCE_TPU_MESH_DEVICES knob without touching a device:
    0 means "all visible devices", otherwise a count with a floor of 1."""
    raw = os.environ.get(MESH_DEVICES_ENV, "1").strip().lower()
    if raw in ("all", "pod"):
        return 0
    try:
        n = int(raw)
    except ValueError:
        return 1
    return 0 if n == 0 else max(1, n)


def serving_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The serving executor's mesh, resolved from the knob over the CUDA
    devices (a mesh of 1 unless the knob asks for more)."""
    if devices is None:
        resolve_device(None)
        n = mesh_devices_requested()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n:
            devices = devices[:min(n, len(devices))]
    return make_mesh(devices)


def workflow_shard(key: Tuple[str, str, str], n_shards: int) -> int:
    """Stable workflow -> shard assignment over the mesh (the analogue of
    the reference's workflowID -> historyShard hash): the same key always
    lands on the same mesh position."""
    if n_shards <= 1:
        return 0
    return zlib.crc32("|".join(key).encode()) % n_shards


def on_device(dev: torch.device):
    """The context a shard's launches run in: its CUDA device current (the
    kernels launch on the current device), nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def shard_bounds(W: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """(lo, hi) of each shard's workflow slice; W must be a multiple of the
    mesh size, as a NamedSharding demands."""
    n = mesh.size
    if W % n:
        raise ValueError(f"{W} workflows do not split evenly over a mesh of {n} devices")
    step = W // n
    return [(d * step, (d + 1) * step) for d in range(n)]


def _to_device(part: np.ndarray, dev: torch.device) -> torch.Tensor:
    if dev.type == "cpu":
        return torch.from_numpy(np.ascontiguousarray(part))
    from ..native.wirec import pinned

    with on_device(dev):
        return pinned(part).to(dev, non_blocking=True)


def place_corpus(array, mesh: Mesh) -> List[torch.Tensor]:
    """Per-device staging of any leading-workflow-axis host array: the
    array splits into `mesh.size` equal workflow slices and each is copied
    to its own device (through page-locked memory, non-blocking, on that
    device's current stream). Returns the shards in mesh order."""
    array = np.asarray(array)
    return [_to_device(array[lo:hi], dev)
            for dev, (lo, hi) in zip(mesh.devices, shard_bounds(array.shape[0], mesh))]


def shard_events(events, mesh: Mesh) -> List[torch.Tensor]:
    """Place [W, E, L] events with W partitioned over the 'shard' axis."""
    if np.ndim(events) != 3:
        raise ValueError(f"events: expected [W, E, L], got shape {np.shape(events)}")
    return place_corpus(events, mesh)


def shard_events32(events32, mesh: Mesh) -> List[torch.Tensor]:
    """Place wire32 [W, E, L32] int32 events sharded over 'shard'."""
    return shard_events(events32, mesh)


def shard_wirec(corpus: WirecCorpus, mesh: Mesh) -> List[Tuple[torch.Tensor, ...]]:
    """A WirecCorpus's (slab, bases, n_events), W partitioned over
    'shard': one tuple per shard, in mesh order."""
    return list(zip(*(place_corpus(a, mesh)
                      for a in (corpus.slab, corpus.bases, corpus.n_events))))


def run_shards(mesh: Mesh, parts, fn) -> list:
    """fn(device, part) for each shard, under that shard's device; the
    launches of every shard are queued before any result is read."""
    outs = []
    for dev, part in zip(mesh.devices, parts):
        with on_device(dev):
            outs.append(fn(dev, part))
    return outs


def gather(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' [W_s, ...] tensors as one [W, ...] tensor in workflow
    order, on the mesh's first device."""
    return torch.cat([t.to(mesh.devices[0]) for t in tensors])


def sum_stats(per_shard: Sequence[torch.Tensor]) -> torch.Tensor:
    """The psum: each shard's [2] int64 counts read back (16 bytes each)
    and summed on the host."""
    return torch.stack([s.cpu() for s in per_shard]).sum(dim=0)


def _gather_with_stats(mesh: Mesh, outs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    first, errors, counts = zip(*outs)
    return gather(mesh, first), gather(mesh, errors), sum_stats(counts)


def _replay_with_stats(ev: torch.Tensor, layout: PayloadLayout):
    """One shard: kernel A on int64 lanes, B, F."""
    s = replay_events(ev, layout, ev.device)
    return payload_rows(s, layout), s.error, stats(s.error, s.close_status)


def replay_sharded(events, mesh: Mesh, layout: PayloadLayout = DEFAULT_LAYOUT
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded replay over the mesh. Returns (payload rows [W, width],
    errors [W], stats [2] = [workflows with an error, workflows closed])."""
    parts = shard_events(events, mesh)
    return _gather_with_stats(mesh, run_shards(
        mesh, parts, lambda dev, ev: _replay_with_stats(ev, layout)))


def _replay_crc_with_stats(ev32: torch.Tensor, layout: PayloadLayout):
    """One shard: kernel A on wire32 lanes, B, C, F."""
    s = replay_events32(ev32, layout, ev32.device)
    return crc32_rows(payload_rows(s, layout)), s.error, stats(s.error, s.close_status)


def replay_sharded_crc(events32, mesh: Mesh, layout: PayloadLayout = DEFAULT_LAYOUT
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded wire32 replay reduced on the devices to (crc32 [W] int64
    holding the unsigned value, errors [W], stats [2]): int32 lanes in,
    4 bytes a workflow out."""
    parts = shard_events32(events32, mesh)
    return _gather_with_stats(mesh, run_shards(
        mesh, parts, lambda dev, ev: _replay_crc_with_stats(ev, layout)))


def _replay_wirec_crc_with_stats(slab, bases, n_events, profile, layout: PayloadLayout):
    """One shard: kernel A's wirec reader, B, C, F."""
    s = replay_wirec(slab, bases, n_events, profile, layout, slab.device)
    return crc32_rows(payload_rows(s, layout)), s.error, stats(s.error, s.close_status)


def replay_wirec_sharded_crc(corpus: WirecCorpus, mesh: Mesh,
                             layout: PayloadLayout = DEFAULT_LAYOUT
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded wirec replay: the compressed slab is what crosses the host
    link; decode, replay, payload and CRC run on the devices. Returns
    (crc32 [W] int64, errors [W], stats [2])."""
    parts = shard_wirec(corpus, mesh)
    return _gather_with_stats(mesh, run_shards(
        mesh, parts,
        lambda dev, p: _replay_wirec_crc_with_stats(*p, corpus.profile, layout)))


# ---------------------------------------------------------------------------
# Capacity-escalation rungs under the shard axis (engine/ladder.py): the
# flagged-row sub-corpus re-replays at a widened K partitioned over the
# same axis as the primary replay. The ladder pads the sub-corpus to a
# multiple of the mesh size with no-op rows.
# ---------------------------------------------------------------------------


def replay_sharded_escalated(events, mesh: Mesh, layout: PayloadLayout,
                             out_layout: PayloadLayout = DEFAULT_LAYOUT):
    """Sharded widened-K re-replay of a flagged sub-corpus; returns (rows
    [F, out width] at the base payload width, errors [F], narrow
    overflow [F], current branch [F])."""
    parts = shard_events(events, mesh)
    outs = run_shards(mesh, parts,
                      lambda dev, ev: replay_escalated(ev, layout, out_layout, dev))
    return tuple(gather(mesh, ts) for ts in zip(*outs))


def replay_wirec_sharded_escalated_crc(corpus: WirecCorpus, mesh: Mesh, layout: PayloadLayout,
                                       out_layout: PayloadLayout = DEFAULT_LAYOUT):
    """Sharded widened-K wirec re-replay reduced to (crc32 [F] int64 at
    the base payload width, errors [F], narrow overflow [F])."""
    parts = shard_wirec(corpus, mesh)
    outs = run_shards(mesh, parts, lambda dev, p: replay_wirec_escalated_crc(
        *p, corpus.profile, layout, out_layout, dev))
    return tuple(gather(mesh, ts) for ts in zip(*outs))
