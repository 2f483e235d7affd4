"""Mixtral-8x22B [arXiv:2401.04088; hf] — 8 experts top-2, SWA: 56L
d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768."""
from .base import ArchConfig
from .registry import register


@register("mixtral-8x22b")
def mixtral() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=32768, head_dim=128,
        rope_theta=1e6, window=4096, mlp_act="swiglu",
        num_experts=8, top_k=2, tie_embeddings=False,
        source="arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1 "
               "(window per assignment brief)",
    )
