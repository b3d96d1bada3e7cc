"""One run of one cell: set-up, the measured window, the check, the result.

Set-up makes the cell's corpus on the device from the seed and hands it
to the port in the form its traffic mix names (entries/), then warms
every shape the window will use by running requests through the
window's own loop. `setup_s` runs from the start of the process to the
first timed request. The end-to-end metrics come from the measured
window, untraced, which makes one pass over the corpus at least. With
`trace` two short traced windows follow it (tracing.py): the per-layer
readers read the first, which records the card's activity alone; the
second, which also records the host's operations, names the device's
idle gaps. After the windows the program's corpus is freed and the
reference checks the sampled answers of every request (verify.py).
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import tracing, verify, window
from .guard import forbidden_modules

#: the traced window's length, seconds; that of the window whose host
#: operations name the device's idle gaps
TRACE_SECONDS = 1.0
NAMING_SECONDS = 0.5
#: requests run through the window's loop before it, to warm every shape
WARM_REQUESTS = 4


@dataclass
class Reading:
    """What a per-layer reader reads: the cell, the untraced window, the
    traced window and its reduced profile."""

    cell: object
    window: window.Window
    traced: Optional[window.Window] = None
    trace: Optional[tracing.Trace] = None


class ForbiddenImport(RuntimeError):
    pass


def quantity(name: str) -> str:
    """The quantity an end-to-end metric measures: its name up to the
    first dot. `verify_events_per_s.basic` is `verify_events_per_s` in the
    cells that list it, held to a bound of its own."""
    return name.split(".", 1)[0]


def _metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda") -> Tuple[dict, List[str]]:
    """(the result line's object, the check's lines for standard error)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    depth = int(cell.mix["depth"])
    resident = cell.entry.prepare(cell, seed, dev)
    idx, sample = verify.draw_sample(seed, resident.workflows, resident.chunk_rows)
    window.run(resident, 0.0, depth, {}, min_requests=WARM_REQUESTS)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    win, k = window.run(resident, seconds, depth, sample, min_requests=resident.n_chunks)
    traced = named = prof = prof_host = None
    reduce_s = 0.0
    if trace:
        t_trace = time.perf_counter()
        (traced, k), prof = tracing.profile(
            lambda: window.run(resident, TRACE_SECONDS, depth, sample, start=k), cuda, False)
        (named, k), prof_host = tracing.profile(
            lambda: window.run(resident, NAMING_SECONDS, depth, sample, start=k, annotate=True),
            cuda, True)
        reduce_s = time.perf_counter() - t_trace - traced.seconds - named.seconds
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    resident.release()
    del resident
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want_crc, want_err = verify.reference_answers(cell, seed, idx, dev)
    reference_s = time.perf_counter() - t_ref
    answers = win.answers + (traced.answers + named.answers if traced else [])
    numbers = verify.compare(answers, idx, cell.mix["chunk_workflows"], want_crc, want_err)
    if numbers["unanswered"]:
        raise RuntimeError(f"{numbers['unanswered']} sampled workflows were never answered")
    checked = verify.checks(numbers)

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        reading = Reading(cell, win, traced, prof)
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(reading)
            if value is not None:
                metrics[m["name"]] = _metric(value, units[m["name"]])
    else:
        e2e = {"verify_events_per_s": win.events / win.seconds,
               "request_ms_p95": window.p95(win.latencies_s) * 1e3,
               "setup_s": setup_s}
        metrics = {m["name"]: _metric(e2e[quantity(m["name"])], units[m["name"]])
                   for m in cell.end_to_end}

    devinfo = {"platform": "gpu" if cuda else dev.type,
               "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
               "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        devinfo["busy_s"] = prof.busy_s
        devinfo["window_s"] = prof.window_s
    result = {"correct": verify.passed(checked),
              "attempted": win.requests + (traced.requests + named.requests if traced else 0),
              "failed": numbers["failed_requests"], "metrics": metrics, "device": devinfo}
    if trace:
        result["breakdown"] = {"device_ops": prof.device_ops(),
                               "idle_gaps": prof_host.idle_gaps()}
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"forbidden modules loaded: {', '.join(found)}")
    result["checks"] = checked
    lines = [f"setup {setup_s:.2f} s, window {win.seconds:.2f} s ({win.requests} requests, "
             f"p95 {window.p95(win.latencies_s) * 1e3:.4f} ms), reference {reference_s:.2f} s, "
             f"trace export and reduction {reduce_s:.2f} s",
             f"answers compared: {numbers['answers']} ({numbers['crc_mismatch']} CRC32s and "
             f"{numbers['error_mismatch']} error flags differ) of {len(idx)} sampled workflows, "
             f"whose CRC32s take {len(np.unique(want_crc))} distinct values"]
    lines += [f"check {name}: {c['value']} limit {c['limit']}" for name, c in checked.items()]
    return result, lines
