"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
— dense: 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""
from .base import ArchConfig
from .registry import register


@register("mistral-large-123b")
def mistral_large() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b", family="dense",
        num_layers=88, d_model=12288, num_heads=96, num_kv_heads=8,
        d_ff=28672, vocab_size=32768, head_dim=128,
        rope_theta=1e6, mlp_act="swiglu", tie_embeddings=False,
        source="hf:mistralai/Mistral-Large-Instruct-2407 (unverified)",
    )
