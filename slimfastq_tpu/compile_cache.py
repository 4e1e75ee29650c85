"""Where JAX keeps its persistent compilation cache.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set nothing
here changes JAX's configuration. Otherwise the cache goes to a fixed
directory of the checkout: the directory is part of what a later run must
find again, so it is never a temporary or per-process path.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``; call
    before the first compilation. Returns the directory."""
    if not os.environ.get(ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
