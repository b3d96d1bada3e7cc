"""The control of the check: the reference in the program's place with a
guarantee of the configuration broken must come out as not correct.

The configuration states its payload rows as int64 words and every
workflow's row equal to the plain replay of its whole history. Its lanes'
values that reach the payload (event ids, counts, ids of pending work) fit
int32 and the wide lanes (timestamps) never reach it, so a computation in
int32, the precision below int64, gives the same rows: `int32_lanes`, the
reference on lanes wrapped to int32, is read to show that. The control
breaks the other guarantee by one event a workflow: `control` is the
reference replaying each history without its last event.

For each seed it makes the cell's corpus as a run does, has the port
answer the first `--requests` chunks through the window's own loop, frees
the corpus, and then replays each of those chunks whole with the
reference, at the cell's own size. It prints, a seed a line, the numbers
a run compares, over every row of those chunks, for the program (the
lower reading), the control (the upper one) and `int32_lanes`, and how
many distinct CRC32s the reference's rows take. The benchmark's own runs
never run it.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...] [--requests 2]
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def without_last_event(lanes):
    """[W, E, 18] int64 lanes with each workflow's last event made padding."""
    import torch

    from perfbench.reference.layout import LANE_EVENT_ID, LANE_EVENT_TYPE

    last = (lanes[..., LANE_EVENT_ID] > 0).sum(dim=1) - 1
    rows = torch.arange(lanes.shape[0], device=lanes.device)
    out = lanes.clone()
    out[rows, last] = 0
    out[rows, last, LANE_EVENT_TYPE] = -1
    return out


def wrapped32(lanes):
    """Every lane wrapped to int32, as an int32 computation would hold it."""
    return ((lanes & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def readings(cell, seed: int, requests: int, device) -> dict:
    """The program's, the control's and the int32 lanes' numbers compared
    over every row of the first `requests` chunks of the cell's corpus
    made from `seed`."""
    import numpy as np
    import torch

    from perfbench import window
    from perfbench.reference import replay_crc
    from perfbench.reference.layout import PayloadLayout
    from perfbench.verify import compare

    resident = cell.entry.prepare(cell, seed, device)
    rows = resident.chunk_rows
    everything = {c: np.arange(rows) for c in range(requests)}
    win, _ = window.run(resident, 0.0, int(cell.mix["depth"]), everything,
                        min_requests=requests)
    resident.release()
    del resident
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    layout = PayloadLayout(**cell.config["layout"])
    histories = cell.generator.Histories(cell.config, device)
    ref, ctl, i32 = [], [], []
    t0 = time.perf_counter()
    for c in range(requests):
        lanes = histories(seed, torch.arange(c * rows, (c + 1) * rows, device=device))
        ref.append(replay_crc(lanes, layout))
        ctl.append(replay_crc(without_last_event(lanes), layout))
        i32.append(replay_crc(wrapped32(lanes), layout))
        del lanes
    reference_s = time.perf_counter() - t0
    idx = np.arange(requests * rows)
    want_crc = np.concatenate([crc for crc, _ in ref])
    want_err = np.concatenate([err for _, err in ref])

    def answers(got):
        return [(c, crc.astype(np.int64), err) for c, (crc, err) in enumerate(got)]

    return {"seed": seed, "rows": int(len(idx)),
            "distinct_crcs": int(len(np.unique(want_crc))),
            "program": compare(win.answers, idx, rows, want_crc, want_err),
            "control": compare(answers(ctl), idx, rows, want_crc, want_err),
            "int32_lanes": compare(answers(i32), idx, rows, want_crc, want_err),
            "reference_s": reference_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=2)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench.catalog import find_cell

    cell = find_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 1
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.requests, torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
