"""DeepSeek-67B [arXiv:2401.02954; hf] — llama-arch dense: 95L d_model=8192
64H (GQA kv=8) d_ff=22016 vocab=102400."""
from .base import ArchConfig
from .registry import register


@register("deepseek-67b")
def deepseek_67b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-67b", family="dense",
        num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=22016, vocab_size=102400, head_dim=128,
        rope_theta=1e4, mlp_act="swiglu", tie_embeddings=False,
        source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base",
    )
