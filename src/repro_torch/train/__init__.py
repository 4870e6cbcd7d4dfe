"""Training substrate of the port: optimizer, step factory, checkpointing,
resilience (``repro.train``'s exports)."""

from . import checkpoint  # noqa: F401
from .fault_tolerance import StragglerMonitor, TrainingRunner, remesh  # noqa: F401
from .grad_compression import compress, decompress, zero_residual  # noqa: F401
from .optimizer import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    schedule,
)
from .train_loop import init_train_state, make_train_step  # noqa: F401
