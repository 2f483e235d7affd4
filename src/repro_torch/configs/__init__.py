"""Architecture configs of the port: the four dense decoders and the two
MoE decoders. The other configs of the JAX package arrive with their
families."""
from .base import ArchConfig
from .registry import get_config, list_archs

# Import for registration side effects.
from . import deepseek_67b, deepseek_moe_16b, h2o_danube_1_8b  # noqa: F401
from . import mistral_large_123b, mixtral_8x22b, starcoder2_7b  # noqa: F401

__all__ = ["ArchConfig", "get_config", "list_archs"]
