"""Persistent XLA compile cache: one rule for every entry point.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
helper sets no other directory. Otherwise the cache lives at one fixed path
inside the checkout (`.jax_cache/`, listed in .gitignore). The path is part
of the cache's key, so it is never derived from a temporary name, a process
id or the time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the compile cache uses under the rule above."""
    return os.environ.get(ENV_VAR) or CHECKOUT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on (call before the first compile) and
    return its directory."""
    import jax

    if not os.environ.get(ENV_VAR):
        os.makedirs(CHECKOUT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    return cache_dir()
