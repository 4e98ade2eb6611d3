"""Model descriptions: the configuration dataclasses of the fleet's
architectures (copied from the JAX package's ``models/config.py``).
The JAX package's ``models`` also holds the transformer itself; the
port's comes with the LM serving path."""
from .config import HybridConfig, MLAConfig, MoEConfig, ModelConfig

__all__ = ["HybridConfig", "MLAConfig", "MoEConfig", "ModelConfig"]
