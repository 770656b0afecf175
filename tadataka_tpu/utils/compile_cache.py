"""Persistent XLA compilation cache location.

A cold run compiles every jitted program, which can dominate a short
run.  JAX keeps compiled executables across processes in a directory
keyed by the program, so a later run finds what an earlier one stored
only if both use the same directory.
"""

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache():
    """Turn on the persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and
    no other directory is set here.  Otherwise the cache lives in the
    repository's ``.jax_cache`` (listed in ``.gitignore``).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
