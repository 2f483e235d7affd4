"""Architecture configs of the port: the dense decoder and the two MoE
decoders. The other configs of the JAX package arrive with their
families."""
from .base import ArchConfig
from .registry import get_config, list_archs

# Import for registration side effects.
from . import deepseek_moe_16b, h2o_danube_1_8b  # noqa: F401
from . import mixtral_8x22b  # noqa: F401

__all__ = ["ArchConfig", "get_config", "list_archs"]
