"""Persistent XLA compile cache placement, shared by the tests, bench.py and
chip_smoke.py.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and this
module sets no other directory. Otherwise the cache lives at a fixed
``.jax_cache/`` beside the package (the repository root in a checkout), so
every process of the checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn the persistent cache on; returns the directory in use. Programs
    that compile faster than ``min_compile_secs`` are not written."""
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
