"""What the benchmark refuses to have loaded: JAX, its libraries and the
JAX package of this repository, compared by whole top-level module names
(the port's ``etts_torch`` is not ``etts``)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "etts")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))
