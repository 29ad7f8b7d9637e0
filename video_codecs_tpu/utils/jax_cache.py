"""Where JAX keeps its persistent compilation cache.

A cache only hits when its directory stays put (the path is part of the
key), so every entry point places it through `enable()`:

  - `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself; nothing is set
    here.
  - otherwise: `<checkout>/.jax_cache`, a fixed path that `.gitignore`
    lists.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")
ENV = "JAX_COMPILATION_CACHE_DIR"


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
