"""JAX's persistent compilation cache, in one fixed place.

The mapping stage compiles many small jits (one set per read-length
bucket), and every process would otherwise compile them again.  The
cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set and in
``<checkout>/.jax_cache`` otherwise; the path is part of the cache key,
so it must not move between runs.  The CPU backend is left alone: its
compiles are cheap, and XLA:CPU executables are tied to the host's
instruction set.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def compile_cache_dir() -> Path:
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_DIR


def enable_compile_cache() -> Path | None:
    """On an accelerator backend, point JAX's persistent cache at
    :func:`compile_cache_dir` and cache every compilation, however
    short.  Returns the directory, or None on the CPU backend."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
