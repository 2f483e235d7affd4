"""Jamba-1.5-Large-398B [arXiv:2403.19887; hf] — hybrid Mamba+attention
1:7 interleave with MoE 16e top-2 every other layer: 72L d_model=8192 64H
(GQA kv=8) d_ff=24576 vocab=65536, ssm_state=128.

As in the JAX package, the mixers are Mamba2/SSD (Jamba's released
checkpoints use Mamba-1 mixers): the same interleave structure. The
parameters are bf16 (398 B parameters at fp32 hold no card's state)."""
from .base import ArchConfig
from .registry import register


@register("jamba-1.5-large-398b")
def jamba() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=24576, vocab_size=65536, head_dim=128,
        rope_theta=1e4, mlp_act="swiglu",
        num_experts=16, top_k=2, moe_every=2,
        ssm_state=128, ssm_expand=2,
        attn_every=8, attn_offset=3,
        tie_embeddings=False,
        param_dtype="bfloat16",
        source="arXiv:2403.19887/2408.12570; hf:ai21labs/AI21-Jamba-1.5-Large",
    )
