"""Runtime knobs: the persistent compilation cache.

The SLAM pipeline compiles ~20 distinct XLA programs (fused track step,
keyframe maintenance, relocalization RANSAC, loop-closing stack), and the
first-run compile cost dominates short sequences. Drivers therefore enable
JAX's persistent compilation cache, so that second and later runs of any
driver reuse every program.
"""
from __future__ import annotations

import os

import jax

# One fixed directory inside the checkout (listed in .gitignore): the
# cache's path is part of what makes a later run find its entries.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives in CACHE_DIR.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return CACHE_DIR
