"""What a run may not have loaded: JAX, its libraries, or the JAX package
the port was made from.  Compared by whole top-level module names, since
the port's own name begins with the JAX package's."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (by default every
    module this process has loaded)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
