"""What the benchmark's process must never load: JAX and the JAX
package.  Module names are compared by their top-level name as a whole
(``repro_torch`` is the port and is not ``repro``)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in ``modules`` (default ``sys.modules``) that are
    forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))
