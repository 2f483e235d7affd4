"""Architecture configs of the port: the four dense decoders, the two
MoE decoders, the SSM, the hybrid, the encoder-decoder and the VLM. The
other configs of the JAX package arrive with their families."""
from .base import ArchConfig
from .registry import get_config, list_archs

# Import for registration side effects.
from . import deepseek_67b, deepseek_moe_16b, h2o_danube_1_8b  # noqa: F401
from . import jamba_1_5_large_398b  # noqa: F401
from . import mamba2_2_7b, mistral_large_123b, mixtral_8x22b  # noqa: F401
from . import qwen2_vl_72b, starcoder2_7b, whisper_medium  # noqa: F401

__all__ = ["ArchConfig", "get_config", "list_archs"]
