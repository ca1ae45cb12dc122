"""Persistent jit-compilation cache at one fixed place.

The cache directory is `JAX_COMPILATION_CACHE_DIR` when that variable is
set, and otherwise `.jax_cache/` at the root of the checkout (listed in
`.gitignore`). The path is part of what a later process must find again,
so it never depends on the working directory or a temporary directory.

Call `enable()` after importing jax in every long-compile entry point
(bench.py, chip_smoke.py, app/run.py, benchmarks/*).
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory compiled executables are kept in."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable(min_compile_time_secs: float = 1.0) -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_time_secs))
    return d
