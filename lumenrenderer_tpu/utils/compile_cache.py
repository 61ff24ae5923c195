"""Persistent XLA compile cache location, shared by the entry points.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives at a fixed `<checkout>/.jax_cache` (listed
in `.gitignore`): the path is part of the cache key, so it must not move
between runs.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir(environ=None) -> str:
    environ = os.environ if environ is None else environ
    return environ.get(ENV) or str(CHECKOUT / ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compile cache at `cache_dir()`; returns it."""
    path = cache_dir()
    if ENV not in os.environ:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
