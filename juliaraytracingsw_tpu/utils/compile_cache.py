"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, ``bench.py``, ``chip_smoke.py``):
if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
else is set in code; otherwise the cache lives at the fixed path
``<checkout>/.jax_cache`` (listed in ``.gitignore``). A fixed path matters
because the path is part of the cache key: a directory that moves never
hits.
"""
from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE", "setup_compile_cache"]

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache(env: dict | None = None) -> str:
    """Point JAX's persistent compile cache at its directory and return
    that directory. Call before the first compilation."""
    env = os.environ if env is None else env
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return env["JAX_COMPILATION_CACHE_DIR"]
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
