"""How `correct` is decided: the port's answers against the plain reference.

A sample of the resident workflows is drawn from the seed before the
window. Every request of the window keeps the answers (CRC32 and error
flag) of the sampled workflows in its chunk; the window cycles over the
corpus, so each sampled workflow is answered many times. Once the window
has closed and the program's corpus is freed, the reference makes the
sampled workflows' int64 lanes again from the seed and works out their
CRC32s and error flags (reference/), and every kept answer is compared.

The number compared is `answer_mismatch`, the kept answers whose CRC32 or
error flag differs from the reference's; an answer is exact, so its limit
is 0. The window makes one pass over the corpus at least, so every
sampled workflow is answered; one that is not is the harness's fault,
and the run stops without a result.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

#: workflows sampled for the check
SAMPLE_WORKFLOWS = 4096
#: the reference replays the sample this many workflows at a time
REFERENCE_BLOCK = 4096


def draw_sample(seed: int, workflows: int, chunk_rows: int,
                size: int = SAMPLE_WORKFLOWS) -> Tuple[np.ndarray, Dict[int, np.ndarray]]:
    """(sorted workflow indices, {chunk: rows of it}) of a sample of
    `size` of the `workflows` resident ones, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(workflows, size=min(size, workflows), replace=False))
    by_chunk = {int(c): (idx[idx // chunk_rows == c] % chunk_rows)
                for c in np.unique(idx // chunk_rows)}
    return idx, by_chunk


def reference_answers(cell, seed: int, idx: np.ndarray,
                      device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """(crc32 [S] uint32, error [S] int32) of the sampled workflows by the
    reference, from lanes it makes again from the seed on `device`."""
    from .reference import replay_crc
    from .reference.layout import PayloadLayout

    layout = PayloadLayout(**cell.config["layout"])
    histories = cell.generator.Histories(cell.config, device)
    crcs, errors = [], []
    for lo in range(0, len(idx), REFERENCE_BLOCK):
        rows = torch.from_numpy(idx[lo:lo + REFERENCE_BLOCK]).to(device)
        lanes = histories(seed, rows)
        crc, err = replay_crc(lanes, layout)
        crcs.append(crc)
        errors.append(err)
        del lanes
    return np.concatenate(crcs), np.concatenate(errors)


def compare(answers: List[Tuple[int, np.ndarray, np.ndarray]], idx: np.ndarray,
            chunk_rows: int, expected_crc: np.ndarray, expected_err: np.ndarray) -> dict:
    """The counts over every kept answer: {"answer_mismatch" (CRC or
    error differs), "crc_mismatch", "error_mismatch", "unanswered",
    "failed_requests", "answers"}."""
    want_crc = expected_crc.astype(np.int64)
    want_err = expected_err.astype(np.int64)
    chunk_of = idx // chunk_rows
    first = {int(c): int(np.searchsorted(chunk_of, c)) for c in np.unique(chunk_of)}
    answered = np.zeros(len(idx), dtype=bool)
    crc_bad = err_bad = both_bad = failed = total = 0
    for chunk, crc, err in answers:
        at = slice(first[chunk], first[chunk] + len(crc))
        bad_c = crc.astype(np.int64) != want_crc[at]
        bad_e = err.astype(np.int64) != want_err[at]
        crc_bad += int(bad_c.sum())
        err_bad += int(bad_e.sum())
        both_bad += int((bad_c | bad_e).sum())
        failed += int(bool(bad_c.any() or bad_e.any()))
        answered[at] = True
        total += len(crc)
    return {"answer_mismatch": both_bad, "crc_mismatch": crc_bad, "error_mismatch": err_bad,
            "unanswered": int((~answered).sum()), "failed_requests": failed,
            "answers": total}


#: the numbers compared and their limits
LIMITS = {"answer_mismatch": 0}


def checks(numbers: dict) -> Dict[str, dict]:
    return {name: {"value": numbers[name], "limit": limit} for name, limit in LIMITS.items()}


def passed(checked: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
