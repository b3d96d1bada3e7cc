"""The engine's bulk verify, one checkout's port against another's, on one card.

    python3 verify_ab.py --parent DIR [--per-suite N] [--reps R]

Runs TPUReplayEngine.verify_all (`admin verify`: kernels A, B, G, D and F)
over the same Stores in a fresh process for each checkout, in the order
parent, this tree, this tree, parent: the histories of chip_smoke.py's
four verify suites (N a suite, 2,048 by default, as chip_smoke.py's
verify_path takes them), the oracle's live states, 64 of them altered as
verify_path alters them. Each process builds its checkout's kernels,
warms up on 256 keys through an engine of its own, then times R runs of
verify_all over every key and R over 4,096 keys on a mesh of two slices
of the card, each through a fresh engine, beside the engine's legs (pack,
its queue wait, h2d, kernel, readback) and the expected rows' time. Each
run must flag exactly the altered keys. One JSON line a process, then
the card's name and power limit, then a summary of medians by checkout.
Without CUDA it exits non-zero at once."""
import argparse
import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _histories(task):
    """One pool task: (suite, first index, count) -> the suite's histories."""
    import chip_smoke as cs
    from cadence_tpu_torch.gen.corpus import generate_history

    suite, start, count = task
    return [generate_history(suite, cs.SEED, i, cs.TARGET_EVENTS)
            for i in range(start, start + count)]


def run(tree: str, per_suite: int, reps: int, device: str = "cuda") -> dict:
    """The timed runs on `tree`'s package (a child process)."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import chip_smoke as cs
    from cadence_tpu_torch.engine.persistence import Stores
    from cadence_tpu_torch.engine.tpu_engine import TPUReplayEngine
    from cadence_tpu_torch.ops import _build
    from cadence_tpu_torch.parallel.mesh import Mesh
    from cadence_tpu_torch.utils import metrics as M

    import cadence_tpu_torch

    if not os.path.abspath(cadence_tpu_torch.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {cadence_tpu_torch.__file__}, not {tree}'s package")
    tasks = [(suite, s, n) for suite in cs.VERIFY_SUITES for s, n in cs._chunks(per_suite, 512)]
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(os.cpu_count()) as pool:
        hists = [h for part in pool.map(_histories, tasks, chunksize=1) for h in part]
        live = [ms for part in pool.map(cs._gen_states, tasks, chunksize=1) for ms in part]
    t_gen = time.perf_counter() - t0
    stores = Stores()
    keys = []
    for h, ms in zip(hists, live):
        key = (h[0].domain_id, h[0].workflow_id, h[0].run_id)
        for b in h:
            stores.history.append_batch(*key, list(b.events))
        stores.execution.upsert_workflow(ms)
        keys.append(key)
    rng = np.random.default_rng(cs.SEED)
    altered = sorted(cs.alter_live_states(stores, keys, rng))
    sub = [keys[int(i)] for i in sorted(rng.choice(len(keys), min(4096, len(keys)),
                                                   replace=False))]
    dev = torch.device(device)

    eng_dev = None if dev.type == "cuda" else dev  # on the card: the serving mesh, as verify_path

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    TPUReplayEngine(stores, chunk_workflows=4096, device=eng_dev).verify_all(keys[:256])
    sync()
    t_warm = time.perf_counter() - t0

    def timed(keys_, mesh):
        M.DEFAULT_REGISTRY.reset()
        engine = TPUReplayEngine(stores, chunk_workflows=4096, mesh=mesh, device=eng_dev)
        sync()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = engine.verify_all(keys_)
        dt = time.perf_counter() - t0
        in_run = set(keys_)
        want = [k for k in altered if k in in_run]
        if sorted(res.divergent) != want:
            raise RuntimeError(f"{len(res.divergent)} divergent keys, not the {len(want)} altered")
        legs = {leg: M.DEFAULT_REGISTRY.histogram(M.SCOPE_TPU_REPLAY, leg).total
                for leg in (M.M_PROFILE_PACK, M.M_PROFILE_PACK_WAIT, M.M_PROFILE_H2D,
                            M.M_PROFILE_KERNEL, M.M_PROFILE_READBACK)}
        return {"seconds": dt, "workflows_per_s": len(keys_) / dt, "legs": legs,
                "expected_rows_s": engine.last_run["expected_rows"],
                "verify_rows_launches": _build.launches["verify_rows"]}

    out = {"tree": tree, "workflows": len(keys), "generate_s": t_gen, "warm_s": t_warm,
           "build_s": _build.build_seconds}
    out["mesh1"] = [timed(keys, None) for _ in range(reps)]
    out["mesh2"] = [timed(sub, Mesh([dev] * 2)) for _ in range(reps)]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", metavar="DIR", help="the root of the other checkout")
    p.add_argument("--per-suite", type=int, default=2048)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--run", metavar="DIR", help=argparse.SUPPRESS)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("verify_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.run:
        print(json.dumps(run(args.run, args.per_suite, args.reps)), flush=True)
        return 0
    if not args.parent or not os.path.isdir(os.path.join(args.parent, "cadence_tpu_torch")):
        print("verify_ab: --parent DIR must hold a cadence_tpu_torch package", file=sys.stderr)
        return 2
    order = [("parent", args.parent), ("change", HERE), ("change", HERE), ("parent", args.parent)]
    results = {"parent": [], "change": []}
    for label, tree in order:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--run", tree,
                               "--per-suite", str(args.per_suite), "--reps", str(args.reps)],
                              capture_output=True, text=True, cwd=HERE)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-8000:], file=sys.stderr)
            print(f"verify_ab: the {label} run failed ({done.returncode})", file=sys.stderr)
            return 1
        rec = json.loads(done.stdout.strip().splitlines()[-1])
        rec["label"] = label
        print(json.dumps(rec), flush=True)
        results[label].append(rec)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    summary = {}
    for label, recs in results.items():
        for mesh in ("mesh1", "mesh2"):
            runs = [r for rec in recs for r in rec[mesh]]
            summary[f"{label} {mesh}"] = {
                "seconds_median": statistics.median(r["seconds"] for r in runs),
                "seconds": [r["seconds"] for r in runs],
                "pack_s_median": statistics.median(r["legs"]["pack"] for r in runs),
                "kernel_s_median": statistics.median(r["legs"]["kernel"] for r in runs)}
    print(json.dumps({"summary": summary, "smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
