"""Persistent XLA compilation cache location for the repo's entry points.

``enable_compilation_cache()`` is called by the scripts (bench.py,
chip_smoke.py, __graft_entry__.py) and the test harness, never at package
import.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
nothing is changed here; otherwise the cache goes to the fixed path
``<repo>/.jax_compilation_cache`` (gitignored), so repeat runs in one
checkout hit the same cache.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["enable_compilation_cache"]

_ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def enable_compilation_cache() -> str:
    """Return the cache directory in effect, setting the repo-local default
    when the environment names none."""
    if os.environ.get(_ENV):
        return os.environ[_ENV]
    path = str(_REPO_ROOT / ".jax_compilation_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
