"""Where the entry points keep JAX's persistent compilation cache."""
from __future__ import annotations

import os

import jax

__all__ = ["REPO_CACHE_DIR", "use_compile_cache"]

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads
    it and nothing is overridden; otherwise the cache is ``<repo>/.jax_cache``
    (a fixed path, since the path is part of the cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
