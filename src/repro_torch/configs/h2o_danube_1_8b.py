"""H2O-Danube-1.8B [arXiv:2401.16818; hf] — llama+mistral mix with sliding
window: 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000."""
from .base import ArchConfig
from .registry import register


@register("h2o-danube-1.8b")
def h2o_danube() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-1.8b", family="dense",
        num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
        d_ff=6912, vocab_size=32000, head_dim=80,
        rope_theta=1e4, window=4096, mlp_act="swiglu",
        tie_embeddings=False,
        source="arXiv:2401.16818; hf:h2oai/h2o-danube-1.8b-base",
    )
