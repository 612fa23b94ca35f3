"""Persistent compilation cache location, shared by every entry script.

A JAX program here compiles for minutes at the benchmark's shapes, so the
entry scripts (bench.py, chip_smoke.py, scripts/) keep XLA's persistent
cache.  The path is part of what makes a cache hit, so it is fixed: the
directory ``JAX_COMPILATION_CACHE_DIR`` names when it is set (JAX reads the
variable itself), otherwise ``.jax_cache`` at the root of the checkout
(listed in .gitignore).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
