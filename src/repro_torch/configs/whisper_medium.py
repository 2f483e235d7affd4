"""Whisper-medium [arXiv:2212.04356; unverified] — encoder-decoder, conv
frontend stubbed (one projection of precomputed mel frames): 24L enc +
24L dec, d_model=1024 16H (kv=16) d_ff=4096 vocab=51865, GELU, LayerNorm,
fixed sinusoidal positions (no RoPE)."""
from .base import ArchConfig
from .registry import register


@register("whisper-medium")
def whisper_medium() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium", family="audio",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=51865, head_dim=64,
        mlp_act="gelu", norm="ln", attn_bias=True,
        encoder_layers=24, frontend="audio_stub", frontend_dim=80,
        tie_embeddings=True,
        source="arXiv:2212.04356; hf:openai/whisper-medium",
    )
