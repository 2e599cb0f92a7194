"""The modules a run may not hold: JAX's and the JAX package's, by
top-level name compared whole (`eprecon_tpu_torch` is not `eprecon_tpu`).
Standard library only, so that the entry point can import it first."""
from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "eprecon_tpu")


def forbidden_modules() -> List[str]:
    """This process's loaded modules whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)
