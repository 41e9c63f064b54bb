"""Profiling helpers — structured replacement for the reference's manual
BenchmarkTools sprinkling + comment history (SURVEY.md §5 'Tracing/profiling').
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def xprof_trace(log_dir: str):
    """Capture a jax.profiler trace (view with xprof/tensorboard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, sync=True, **kwargs):
    """(result, wall_s); with ``sync`` the clock stops after
    ``jax.block_until_ready`` on the result, so it covers the device work
    and not just the enqueue."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        out = jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def compile_stats(fn, *args, static_argnames=(), **kwargs) -> dict:
    """Lowering/compile cost summary for a jittable function — the analog of
    the reference's allocation-contract tests (test/runtests.jl:129-158):
    assert no recompiles and bounded program size instead of zero heap allocs."""
    jitted = jax.jit(fn, static_argnames=static_argnames)
    t0 = time.time()
    lowered = jitted.lower(*args, **kwargs)
    lower_s = time.time() - t0
    t0 = time.time()
    compiled = lowered.compile()
    compile_s = time.time() - t0
    try:
        mem = compiled.memory_analysis()
        hbm = {"argument_bytes": getattr(mem, "argument_size_in_bytes", None),
               "output_bytes": getattr(mem, "output_size_in_bytes", None),
               "temp_bytes": getattr(mem, "temp_size_in_bytes", None)}
    except Exception:
        hbm = {}
    return {"lower_s": round(lower_s, 3), "compile_s": round(compile_s, 3),
            **hbm}
