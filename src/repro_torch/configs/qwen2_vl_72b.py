"""Qwen2-VL-72B [arXiv:2409.12191; hf] — the VLM backbone with M-RoPE over
[3, B, S] position streams (temporal, height, width); the vision tower is a
stub, as in the reference: callers hand ``forward`` patch and text
embeddings (``embeds=``). 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, attention biases, an untied readout."""
from .base import ArchConfig
from .registry import register


@register("qwen2-vl-72b")
def qwen2_vl() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-72b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        rope_theta=1e6, mrope_sections=(16, 24, 24),
        attn_bias=True, mlp_act="swiglu",
        frontend="vision_stub", tie_embeddings=False,
        source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B-Instruct",
    )
