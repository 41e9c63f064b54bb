"""Which kernels the current backend runs.

Everything in this package is plain JAX except the ray-sphere sweep, which
has a Pallas kernel for NVIDIA GPUs (ops/pallas/intersect_kernel.py,
``backend="triton"``). This module holds the one decision that remains:
whether the integrators call that kernel or the XLA sweep
(ops/intersect.py). On a GPU the kernel is used and a kernel that fails to
compile is an error, never a quiet switch to XLA; every other backend takes
the XLA sweep.
"""

from __future__ import annotations


def use_sweep_kernel(backend: str | None = None) -> bool:
    """True when the integrators should call the Pallas sweep kernel on
    ``backend`` (default: JAX's default backend)."""
    if backend is None:
        import jax
        backend = jax.default_backend()
    return backend == "gpu"
