"""The import guard: the benchmark measures the port alone, so the process
that prints the result may hold no module of JAX or of the JAX package.
Names are compared whole, by their top-level part: ``stein_tpu_torch``
is the port and passes; ``stein_tpu`` is the JAX package and fails."""

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "stein_tpu"})


def banned_modules(modules=None):
    """The loaded top-level names that are banned, sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & BANNED)
