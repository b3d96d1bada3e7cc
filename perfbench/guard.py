"""The benchmark measures the port alone: no JAX, no JAX package.

Module names are compared by their top-level name, the part before the
first dot, as a whole: `cadence_tpu_torch` is the port and passes,
`cadence_tpu` is the JAX package and fails.
"""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cadence_tpu"})


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules (or `names`) whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
