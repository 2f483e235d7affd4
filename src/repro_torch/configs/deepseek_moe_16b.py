"""DeepSeekMoE-16B [arXiv:2401.06066; hf] — fine-grained MoE: 28L
d_model=2048 16H (kv=16) per-expert d_ff=1408, 64 routed top-6 + 2 shared,
first layer dense, vocab=102400. The first layer's MLP is d_ff wide, as
the reference builds it (its plan never carries the dense-width suffix
that would select ``dense_d_ff``)."""
from .base import ArchConfig
from .registry import register


@register("deepseek-moe-16b")
def deepseek_moe() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102400, head_dim=128,
        rope_theta=1e4, mlp_act="swiglu",
        num_experts=64, top_k=6, num_shared_experts=2,
        first_dense_layers=1, dense_d_ff=10944,
        tie_embeddings=False,
        source="arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
    )
