"""Test harness.

The platform comes from ``JAX_PLATFORMS``. CPU runs get 8 virtual devices
(the flag below only affects the CPU backend), which the mesh tests use.
Tests marked ``gpu`` need the card: they skip elsewhere, decided by the
autouse fixture below when the test runs, never at import. On the card:

    python -m pytest -m gpu tests/

The persistent compile cache follows ``JAX_COMPILATION_CACHE_DIR`` when it
is set and ``<repo>/.jax_cache`` otherwise (bayesnmf_tpu/utils/
compile_cache.py).
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

from bayesnmf_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)
enable_compile_cache(min_compile_secs=2.0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables + tracing caches after every test module.

    A long single-process run used to crash inside XLA:CPU's compiler after
    many programs had accumulated in one process (any single file passed in
    isolation). Clearing JAX's executable/tracing caches at module
    boundaries bounds the accumulation; each module recompiles its own
    programs, which it would have had to do under per-file isolation anyway.
    """
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless this process runs on a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        backend = jax.default_backend()
        if backend != "gpu":
            pytest.skip(f"needs a GPU (this process runs on {backend!r}); "
                        "run `python -m pytest -m gpu tests/` on the card")
