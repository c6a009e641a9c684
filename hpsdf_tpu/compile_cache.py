"""Persistent XLA compilation cache for the entry points.

A cold run of the fit, trace and mesh programs spends most of its first
minutes compiling. JAX can keep compiled executables on disk and find them
again in a later process, keyed (among other things) by the cache path, so
the path must not move between runs.

The library never sets a cache on import; entry points (``chip_smoke.py``,
``bench.py``, ``examples/end_to_end.py``) call :func:`enable` first.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# <checkout>/.jax_cache: fixed, so repeated runs from one checkout hit
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`enable` uses: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return that directory."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
