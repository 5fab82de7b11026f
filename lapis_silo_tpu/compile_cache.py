"""JAX's persistent compilation cache, in one place.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at <repo>/.jax_cache, a fixed path (the
path is part of the cache key) that .gitignore lists.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def configure() -> str:
    """Point JAX at the cache directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
