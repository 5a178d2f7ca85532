"""JAX persistent compilation cache location, shared by every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at one fixed directory inside the
checkout (``.jax_cache``, git-ignored): the path is part of the cache key's
context, so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
