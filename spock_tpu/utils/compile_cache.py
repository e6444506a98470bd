"""JAX persistent compilation cache location.

Entry scripts (``bench.py``, ``chip_smoke.py``, the examples) call
:func:`enable` before their first compile.  ``JAX_COMPILATION_CACHE_DIR``,
when set, wins: JAX reads it itself and nothing is changed here.  Otherwise
the cache lives at ``<checkout>/.jax_cache``, a fixed path derived from this
package's location (the path is part of the cache key, so it must not move
between runs).
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def default_dir() -> str:
    """``<checkout>/.jax_cache`` for the checkout holding this package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    path = default_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
