"""The modules a run of the benchmark must never load."""

from __future__ import annotations

import sys
from typing import List

# whole top-level names: the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "mlc_llm_tpu")


def forbidden_modules(names=None) -> List[str]:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
