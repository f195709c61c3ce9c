"""Persistent XLA compilation cache for the program's launchers.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here names another directory. Otherwise the cache lives at one fixed path,
``<checkout>/.jax_cache``, resolved from this package's location rather than
the working directory: JAX keys its entries by path, so a cache that moved
with the cwd would never hit. A relaunch of the same configuration then
loads the compiled step programs instead of compiling them again.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on for this process; returns its directory.
    Call it before the first compile: JAX decides once per process, at its
    first compile, whether the cache is in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program, however quick its compile: the model's small
    # helper programs add up across a relaunch
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
