"""AdamW with ZeRO-1 optimizer-state specs (the JAX package's
``optim/``)."""
from .adamw import AdamWState, adamw_init, adamw_update, zero1_specs

__all__ = ["AdamWState", "adamw_init", "adamw_update", "zero1_specs"]
