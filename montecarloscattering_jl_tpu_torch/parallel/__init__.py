"""Data parallelism over the particle batch, multi-process scale-out and
checkpoints (the JAX package's parallel/)."""

from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .multihost import (  # noqa: F401
    global_state,
    init_distributed,
    spawn,
)
from .shard import (  # noqa: F401
    DP_AXIS,
    Mesh,
    make_mesh,
    pad_to_devices,
    shard_state,
)
