"""One place that decides where JAX keeps its persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
directory is set here.  Otherwise the cache lives at ``<repo>/.jax_cache``:
a fixed path, because the path is part of what makes a later run hit.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
