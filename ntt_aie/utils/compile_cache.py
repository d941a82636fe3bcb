"""Persistent XLA compile cache for the entry points (bench.py,
chip_smoke.py, the CLI). Nothing happens at import: callers opt in."""

from __future__ import annotations

import os
from pathlib import Path

# A fixed path inside the checkout (listed in .gitignore): the cache key
# includes nothing of the path, but a directory that moves never hits.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already uses that directory
    and nothing else is configured. Otherwise the cache goes to
    ``<checkout>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
