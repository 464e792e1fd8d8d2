"""Persistent XLA compile cache for the library's scripts.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and nothing else
is configured.  Otherwise the cache lives at one fixed path inside the
checkout (``.jax_cache/``, ignored by git): a fixed path is part of the
cache key, so repeat runs from the same checkout find their executables.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=None):
    """The cache directory: the environment variable's value, or the fixed
    path inside the checkout."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable():
    """Point JAX's persistent compile cache at :func:`cache_dir`; returns
    the path.  Call before the first compilation."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
