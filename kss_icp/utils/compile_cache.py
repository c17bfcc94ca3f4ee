"""JAX's persistent compilation cache, configured in one place.

Every entry point that compiles the pipeline (the CLI, bench.py,
chip_smoke.py and the scripts under scripts/) calls enable_compile_cache()
once, after importing jax and before the first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# Fixed, inside the checkout and listed in .gitignore: the cache key holds
# the directory, so a path that moved from run to run would never hit.
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX has already read it and
    this sets nothing. Otherwise the cache goes to CHECKOUT_CACHE_DIR."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
