"""Where the persistent XLA compilation cache lives.

One rule for every entry point (CLI, bench.py, chip_smoke.py, examples):
``JAX_COMPILATION_CACHE_DIR`` when it is set, else ``.jax_cache`` at the
root of the checkout.  The path is part of the cache key, so it never
moves between runs: no temporary, per-process or time-stamped directory.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(CHECKOUT / ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()
    (call before the first compile); returns the directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
