"""Checkpoints (the JAX package's parallel/; mesh and multi-host: not
ported yet)."""

from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
