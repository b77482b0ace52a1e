"""Persistent XLA compilation cache at a fixed path.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
here changes. Otherwise the cache lives in `<checkout>/.jax_cache`: a path
that does not move between runs, so a second process finds what the first
one compiled.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
