"""Persistent compilation cache placement, shared by every entry point."""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``$JAX_COMPILATION_CACHE_DIR``
    when that is set, else at ``<checkout>/.jax_cache``; returns the path.

    Works after JAX is imported, as long as nothing has compiled yet: the
    environment variable alone is read only when JAX is first imported."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path
