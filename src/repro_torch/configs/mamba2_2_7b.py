"""Mamba2-2.7B [arXiv:2405.21060; unverified] — attention-free SSD: 64L
d_model=2560, ssm_state=128, vocab=50280."""
from .base import ArchConfig
from .registry import register


@register("mamba2-2.7b")
def mamba2() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2,
        tie_embeddings=True,
        source="arXiv:2405.21060; hf:state-spaces/mamba2-2.7b (unverified)",
    )
