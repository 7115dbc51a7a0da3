"""JAX persistent compilation cache at one fixed place.

The cache key includes the directory, so a path that moves between runs
never hits. The directory is `JAX_COMPILATION_CACHE_DIR` when that is set,
and otherwise `.jax_cache` at the root of the checkout (git-ignored).
"""
from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """The compile-cache directory this checkout uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and cache every compiled program. Returns the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
