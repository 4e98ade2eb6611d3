"""Models: the configuration dataclasses of the fleet's architectures
(copied from the JAX package's ``models/config.py``) and the serving path
of every family (``layers``, ``ssm``, ``transformer``); training comes
with a later slice."""
from .config import HybridConfig, MLAConfig, MoEConfig, ModelConfig
from .transformer import ModelApi, get_api

__all__ = ["HybridConfig", "MLAConfig", "MoEConfig", "ModelConfig",
           "ModelApi", "get_api"]
