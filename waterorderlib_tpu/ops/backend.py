"""The one place that decides which implementation serves a device-specific
choice: hand-written GPU kernels run only when JAX's default backend is an
NVIDIA GPU, and every other backend takes the plain XLA path."""

from __future__ import annotations

import jax


def is_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"
