"""Persistent XLA compilation cache for the entry points.

Every command-line entry point (the runners' ``main``, ``bench.py``,
``chip_smoke.py``) calls :func:`enable_compile_cache` first, so a second
run of the same program on the same machine reuses the compiled
executables instead of compiling again. The library itself sets nothing
at import time.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
helper sets no other directory. Otherwise the cache lives at the fixed
path ``<checkout>/.jax_cache`` (listed in ``.gitignore``): the path is part
of the cache key, so it is never built from a temp name, a PID or the
time.
"""

from __future__ import annotations

import os
import pathlib

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
