"""Placement of the persistent compile cache (utils/compile_cache.py)."""

import os

import jax
import pytest

from bayesnmf_tpu.utils import compile_cache as CC


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set (JAX reads it; nothing else
    is configured); otherwise the cache is <repo>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv(CC.ENV_VAR, str(tmp_path))
    else:
        monkeypatch.delenv(CC.ENV_VAR, raising=False)
    try:
        got = CC.enable_compile_cache()
        if env_set:
            assert got == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
