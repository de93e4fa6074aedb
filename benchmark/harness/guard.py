"""The modules no run may load: JAX and the JAX package, compared by the
whole top-level name (the part before the first dot), so the port, whose
name begins with the JAX package's, passes."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "localrf_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in `modules` (default sys.modules) that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
