"""Where the persistent XLA compilation cache lives.

The cache's path is part of its key, so it must not move between runs. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
overrides it; otherwise scripts of this repository (``chip_smoke.py``,
``bench.py``, ``examples/``) keep the cache at ``<repo>/.jax_cache``, which
``.gitignore`` lists.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory: ``JAX_COMPILATION_CACHE_DIR`` if set, else
    :data:`REPO_CACHE_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
