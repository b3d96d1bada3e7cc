"""The traffic mixes' entries: each holds the cell's corpus resident in one
of the port's forms and calls one of the port's replay entry points once
a request. `prepare(cell, seed, device)` returns an object with
`device`, `workflows`, `chunk_rows`, `n_chunks`, `request(chunk)` (the
port's (crc32, error) of that chunk), `events(chunk)` (its real events),
`bytes(chunk)` (kernel A's input and output bytes, from shapes) and
`release()`."""
from typing import Tuple


def chunking(cell, block: int) -> Tuple[int, int, int]:
    """(resident workflows, workflows a request, requests a pass): the
    configuration's whole corpus in whole chunks of the mix's
    `chunk_workflows`, each chunk whole blocks of the generator's `block`
    workflows, so that every request is the same work."""
    workflows = int(cell.config["workflows"])
    rows = int(cell.mix["chunk_workflows"])
    if workflows % rows or rows % block:
        raise ValueError(f"{workflows} workflows are not whole chunks of {rows}, "
                         f"or {rows} not whole blocks of {block}")
    return workflows, rows, workflows // rows
