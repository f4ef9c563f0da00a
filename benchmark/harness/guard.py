"""The import guard: the benchmark measures the PyTorch port, and no
module of JAX or of the JAX package may be loaded in its process.
Modules are compared by their top-level name, the part before the first
dot, whole: ``montecarloscattering_jl_tpu_torch`` is the port and passes,
``montecarloscattering_jl_tpu`` is the JAX package and fails."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "montecarloscattering_jl_tpu")


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
