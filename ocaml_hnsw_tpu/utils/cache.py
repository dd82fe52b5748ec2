"""Persistent XLA compile cache.

A cold 1M build and its queries compile many large programs (the bulk
passes, the insert-round scan, the engines); the persistent cache lets a
later process load them from disk instead.  The cache directory is
`JAX_COMPILATION_CACHE_DIR` when that is set (JAX reads it itself, and this
module sets no other); otherwise the fixed `.jaxcache/` in the checkout.
The path is part of the cache key, so it never varies with a pid or time.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jaxcache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Turn on the JAX persistent compilation cache and return its
    directory.  Safe to call after backend initialization (the cache is
    consulted per compile)."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
