"""Where JAX keeps its persistent compile cache, for every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache goes to ``<checkout>/.jax_cache`` — a
fixed path, since the path is part of the cache key, so a directory made
from a temporary name, a pid or the time would never hit again.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
