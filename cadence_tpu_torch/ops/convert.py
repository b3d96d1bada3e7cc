"""Carry a ReplayState and a TaskLog across from the JAX package, and back.

There are no weights in this system; what crosses between the two
packages is state: a device-resident ReplayState carried between appends,
and the task logs a task-emitting replay fills. A state crosses as a plain
mapping of numpy arrays under the dotted field paths of ops/state.py
`leaves()` ("state", "activities.occ", ...), a task log as one under its
field names ("tr_type", ..., "overflow"), so this package never sees a JAX
type.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..device import resolve_device
from .state import ReplayState, init_state, leaves, map_state
from .taskgen import TaskLog, field_spec


def state_from_numpy(mapping: Mapping[str, np.ndarray], device=None) -> ReplayState:
    """A ReplayState on `device` (None: the card) from {dotted field path:
    array}. Every field must be present, with the dtype and the trailing
    shape that the layout implied by the arrays gives."""
    from ..core.checksum import PayloadLayout

    vh = np.asarray(mapping["vh_event_ids"])
    layout = PayloadLayout(
        max_version_history_items=vh.shape[2], max_branches=vh.shape[1],
        max_activities=np.asarray(mapping["activities.occ"]).shape[1],
        max_timers=np.asarray(mapping["timers.occ"]).shape[1],
        max_children=np.asarray(mapping["children.occ"]).shape[1],
        max_request_cancels=np.asarray(mapping["cancels.occ"]).shape[1],
        max_signals=np.asarray(mapping["signals.occ"]).shape[1],
    )
    W = vh.shape[0]
    device = resolve_device(device)
    template = init_state(W, layout, "meta")
    names = [name for name, _ in leaves(template)]
    missing = set(names) - set(mapping)
    extra = set(mapping) - set(names)
    if missing or extra:
        raise KeyError(f"state fields missing {sorted(missing)}, unknown {sorted(extra)}")
    it = iter(names)

    def build(ref):
        name = next(it)
        t = torch.tensor(np.asarray(mapping[name]))
        if t.dtype != ref.dtype or tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                             f"{ref.dtype} {tuple(ref.shape)}")
        return t.to(device)

    return map_state(build, template)


def state_to_numpy(state: ReplayState) -> Dict[str, np.ndarray]:
    """{dotted field path: numpy array} for every tensor of `state`."""
    return {name: t.detach().cpu().numpy() for name, t in leaves(state)}


def task_log_from_numpy(mapping: Mapping[str, np.ndarray], device=None) -> TaskLog:
    """A TaskLog on `device` (None: the card) from {field name: array}:
    every TaskLog field, [W, Tt] / [W, Tm] / [W] int64 and a [W] bool
    overflow flag."""
    device = resolve_device(device)
    missing = set(TaskLog._fields) - set(mapping)
    extra = set(mapping) - set(TaskLog._fields)
    if missing or extra:
        raise KeyError(f"task log fields missing {sorted(missing)}, unknown {sorted(extra)}")
    fields = {name: torch.tensor(np.asarray(mapping[name])) for name in TaskLog._fields}
    W = fields["overflow"].shape[0]
    Tt, Tm = fields["tr_type"].shape[-1], fields["tm_type"].shape[-1]
    for name, t in fields.items():
        dtype, shape = field_spec(name, W, Tt, Tm)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected {dtype} {shape}")
    return TaskLog(**{name: t.to(device) for name, t in fields.items()})


def task_log_to_numpy(log: TaskLog) -> Dict[str, np.ndarray]:
    """{field name: numpy array} for every tensor of `log`."""
    return {name: t.detach().cpu().numpy() for name, t in zip(TaskLog._fields, log)}
