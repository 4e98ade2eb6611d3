"""Models: the configuration dataclasses of the fleet's architectures
(copied from the JAX package's ``models/config.py``) and the training and
serving paths of every family (``layers``, ``ssm``, ``transformer``)."""
from .config import HybridConfig, MLAConfig, MoEConfig, ModelConfig
from .layers import param_specs
from .transformer import ModelApi, get_api, lm_loss_from_hidden

__all__ = ["HybridConfig", "MLAConfig", "MoEConfig", "ModelConfig",
           "ModelApi", "get_api", "lm_loss_from_hidden", "param_specs"]
