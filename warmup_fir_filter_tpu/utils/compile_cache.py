"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, ``chip_smoke.py`` and the
benchmark harnesses): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set here; otherwise the cache lives at
``<checkout>/.jax_cache``.  The path is part of the cache key, so it is
fixed rather than per-run.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory.

    Returns the directory in use.  Call before the first compilation:
    JAX opens the cache once, at the first compile of the process.
    """
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
