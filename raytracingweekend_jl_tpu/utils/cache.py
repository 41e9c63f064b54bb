"""Persistent XLA compilation cache.

Every driver (the CLI, ``bench.py``, ``chip_smoke.py``) compiles the same
large programs in each fresh process. JAX's persistent compilation cache
serializes compiled executables to disk keyed on (HLO, compile options,
backend), so a second process running the same program skips compilation.
The cache path is part of what makes a later process find an entry, so it
never moves: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it
(JAX reads that variable itself), else ``.jax_cache/`` at the root of the
checkout (git-ignored). The reference has no analog — Julia's precompile
cache plays this role there (SURVEY.md §2.2 packaging).
"""

from __future__ import annotations

import os

#: Fixed cache location used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir(environ=None) -> str:
    """The cache directory the rule above picks for ``environ``
    (default ``os.environ``); "" when ``RTW_NO_CACHE`` disables caching."""
    env = os.environ if environ is None else environ
    if env.get("RTW_NO_CACHE"):
        return ""
    return env.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache at :func:`cache_dir`
    (idempotent). ``RTW_NO_CACHE=1`` disables it (useful when measuring
    cold-compile time itself). Returns the directory, or "" when disabled.
    """
    path = cache_dir()
    if not path:
        return ""
    import jax

    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything that took noticeable compile time, and entries of
    # any size (the defaults skip small programs).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
