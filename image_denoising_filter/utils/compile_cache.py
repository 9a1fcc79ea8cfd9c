"""Persistent XLA compilation cache.

The radius-20 stencil kernels and the 196-offset NLM kernel take seconds to
compile; the persistent cache makes repeat CLI/bench invocations start
quickly -- the analog of shipping precompiled SPIR-V (the reference compiles
shaders once in compile_shaders.sh, not per run).

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads
it itself, so no location is set in code), otherwise a fixed `.jax_cache`
directory inside the checkout (listed in .gitignore). The path is part of
the cache's key, so it must not move between runs."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Turn the persistent cache on and return its directory. Failures to
    create or configure it propagate: a silently missing cache only shows
    up later as slow starts."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
