"""Atomic, asynchronous checkpoints (the JAX package's ``checkpoint/``)."""
from .store import (CheckpointManager, latest_step, load_checkpoint,
                    save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "save_checkpoint"]
