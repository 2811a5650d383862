"""Which modules a benchmark process may not hold.

The benchmark measures the PyTorch port alone: no module of JAX, jaxlib,
flax or the JAX package `thermal3d` may be loaded. Names are compared by
their top-level part (before the first dot) whole, since the port's name,
`thermal3d_torch`, begins with the JAX package's.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "thermal3d")


def loaded(names: Iterable[str], modules=None) -> List[str]:
    """The top-level names among `names` that `modules` (sys.modules) holds."""
    tops = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops & set(names))


def forbidden_loaded(modules=None) -> List[str]:
    return loaded(FORBIDDEN, modules)
