"""Where JAX keeps its persistent compilation cache.

Compiling the 4096² programs takes a large share of a cold run, so every
entry point (the CLI, ``chip_smoke.py``, ``bench.py``) turns the cache on
through this one helper.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, so nothing is changed); otherwise keep the cache in the
    checkout's ``.jax_cache``. Returns the directory in use."""
    path = os.environ.get(ENV)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
