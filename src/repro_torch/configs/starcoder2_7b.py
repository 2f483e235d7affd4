"""StarCoder2-7B [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE, biases,
GELU MLP (non-gated), learned... we follow the brief: 32L d_model=4608 36H
(GQA kv=4) d_ff=18432 vocab=49152."""
from .base import ArchConfig
from .registry import register


@register("starcoder2-7b")
def starcoder2_7b() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-7b", family="dense",
        num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
        d_ff=18432, vocab_size=49152, head_dim=128,
        rope_theta=1e5, attn_bias=True, mlp_act="gelu",
        tie_embeddings=False,
        source="arXiv:2402.19173; hf:bigcode/starcoder2-7b",
    )
