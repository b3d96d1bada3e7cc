"""Driver entry points of the port: a one-device replay step and a dry run
across devices.

entry() returns the flagship replay step (kernel A over the event axis,
then kernel B's canonical checksum payload) with its example arguments,
eight tiny `basic` workflows on the device. dryrun_multichip(n) serves a
corpus of at least 4,096 workflows from all five suites through the bulk
executor (engine/executor.replay_corpus_mesh) over a mesh of n devices,
holds every payload row to the oracle's, checks the one-shot sharded
replay's rows and cross-shard stats and the compressed (wirec) stream's
CRCs against it, and then serves the same corpus from meshes of another
shape (the devices reversed; half of them), whose rows must be identical.
It ends with a scaling line: the same replay timed on one device and on
the n, printed as one JSON object.

Every device is a card unless the caller names others: `devices=["cpu"] *
n` runs the plain PyTorch versions, n CPU slices standing for n shards.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from .device import resolve_device


def _tiny_events(num_workflows: int, target_events: int = 24) -> np.ndarray:
    from .gen.corpus import generate_corpus
    from .ops.encode import encode_corpus

    histories = generate_corpus("basic", num_workflows=num_workflows, seed=1,
                                target_events=target_events)
    return encode_corpus(histories)


def entry(device=None):
    """Returns (fn, example_args): the replay step on packed events
    [8, E, 18] int64 on `device` (None: the card)."""
    from .ops.replay import replay_to_payload

    dev = resolve_device(device)
    events = torch.as_tensor(_tiny_events(8), device=dev)

    def fn(ev):
        rows, errors = replay_to_payload(ev, device=dev)
        return rows, errors

    return fn, (events,)


def _devices(n_devices: int, devices=None) -> list:
    if devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
        return [torch.device(d) for d in devices[:n_devices]]
    resolve_device(None)
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
    return [torch.device("cuda", i) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, devices=None, min_workflows: int = 4096) -> dict:
    """The dry run over a mesh of `n_devices` of `devices` (None: the
    cards). Raises on any divergence; returns the scaling line's dict."""
    from .core.checksum import STICKY_ROW_INDEX, crc32_of_rows, payload_row
    from .engine.executor import replay_corpus_mesh, stream_wirec_mesh
    from .gen.corpus import SUITES, generate_corpus
    from .native.wirec import pack_wirec_auto
    from .ops.encode import LANE_EVENT_ID, encode_corpus
    from .oracle.state_builder import StateBuilder
    from .parallel.mesh import Mesh, replay_sharded

    devs = _devices(n_devices, devices)
    # at least min_workflows workflows, all suites, a width the mesh divides
    per_suite = -(-min_workflows // (len(SUITES) * n_devices)) * n_devices
    histories = []
    for suite in SUITES:
        histories.extend(generate_corpus(suite, num_workflows=per_suite, seed=7,
                                         target_events=24))
    events = encode_corpus(histories)
    W = events.shape[0]
    assert W >= min_workflows, W
    chunk = max(n_devices, W // 4)

    mesh = Mesh(devs)
    rows, errors, _branch, _report = replay_corpus_mesh(events, mesh, chunk_workflows=chunk)
    assert (errors == 0).all(), f"dry run replay flagged {int((errors != 0).sum())} errors"
    # the cross-shard stats: one one-shot sharded pass, whose rows must
    # equal the executor's
    rows_1shot, _err, stats = replay_sharded(events, mesh)
    assert (rows_1shot.cpu().numpy() == rows).all(), \
        "one-shot sharded replay diverged from the bulk executor"
    stats = stats.cpu().numpy()
    assert stats[0] == 0, f"stats error count: {stats}"
    assert stats[1] == W, f"expected all {W} workflows closed: {stats}"

    # every payload row equal to the oracle's (the sticky field is
    # active-side only and 0 on both sides here)
    for i, h in enumerate(histories):
        expected = payload_row(StateBuilder().replay_history(h))
        expected[STICKY_ROW_INDEX] = 0
        if not (rows[i] == expected).all():
            bad = np.nonzero(rows[i] != expected)[0]
            raise AssertionError(f"payload divergence at workflow {i} fields {bad[:8]}")

    # the compressed wire format under sharding: the wirec stream's CRCs
    # equal the dense path's
    corpus = pack_wirec_auto(events)
    n_chunks = next(nc for nc in (4, 2, 1) if W % nc == 0 and (W // nc) % n_devices == 0)
    crcw, errw, _ = stream_wirec_mesh(corpus, mesh, n_chunks=n_chunks)
    assert (errw == 0).all(), "wirec sharded replay flagged errors"
    assert (crcw == crc32_of_rows(rows)).all(), \
        "wirec sharded CRCs diverge from the dense path's payload CRCs"

    # resharding never changes a row: every shard's data on another
    # device (the mesh reversed), and for n >= 4 shards merged pairwise
    reshaped = []
    if n_devices >= 2:
        reshaped.append(Mesh(list(reversed(devs))))
    if n_devices >= 4:
        reshaped.append(Mesh(devs[:n_devices // 2]))
    for other in reshaped:
        rows_o, errors_o, _, _ = replay_corpus_mesh(events, other, chunk_workflows=chunk)
        assert (errors_o == 0).all()
        assert (rows_o == rows).all(), f"replay on {other} diverged"

    # the scaling line: the same executor replay on one device and on n
    real_events = int((events[:, :, LANE_EVENT_ID] > 0).sum())

    def rate_on(m: Mesh) -> float:
        replay_corpus_mesh(events, m, chunk_workflows=chunk)  # warm
        t0 = time.perf_counter()
        replay_corpus_mesh(events, m, chunk_workflows=chunk)
        return real_events / (time.perf_counter() - t0)

    rate_1 = rate_on(Mesh(devs[:1]))
    rate_n = rate_on(mesh)
    line = {"workflows": W, "events": real_events, "devices": n_devices,
            "device_names": [str(d) for d in devs], "chunk_workflows": chunk,
            "rate_n1": rate_1, f"rate_n{n_devices}": rate_n,
            "speedup": rate_n / rate_1,
            "per_device_efficiency": rate_n / (rate_1 * n_devices)}
    print(json.dumps({"sharded_scaling": line}))
    return line


if __name__ == "__main__":
    n = max(1, torch.cuda.device_count())
    dryrun_multichip(n)
    print("dryrun_multichip ok")
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
