"""The run's guard against the JAX package and JAX itself.

A module counts by its top-level name, the part before the first dot,
compared whole: ``magellanmapper_torch`` begins with the JAX package's
name and is not it.
"""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "magellanmapper_tpu"))


def forbidden(module_names: Iterable[str]) -> List[str]:
    """The loaded top-level names among :data:`FORBIDDEN`, sorted."""
    return sorted({name.split(".", 1)[0] for name in module_names}
                  & FORBIDDEN)
