"""ArchConfig: one dataclass describes an architecture. Counterpart of
``repro.configs.base`` — same fields, so a config built for the JAX
package maps onto the port field by field; the port serves the dense
``attn_mlp`` plan so far."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.qtypes import QuantConfig

Plan = Tuple[Tuple[str, int], ...]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | ssm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention
    rope_theta: float = 1e4
    window: Optional[int] = None     # sliding-window attention
    mrope_sections: Optional[Tuple[int, int, int]] = None
    attn_bias: bool = False
    mlp_act: str = "swiglu"
    norm: str = "rms"                # rms | ln

    # moe
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    moe_every: int = 1

    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0
    attn_offset: int = 3

    # encoder-decoder
    encoder_layers: int = 0
    frontend: Optional[str] = None
    frontend_dim: int = 0

    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"
    quant: QuantConfig = dataclasses.field(
        default_factory=lambda: QuantConfig(mode="qat"))
    remat: str = "full"
    q_block: int = 512
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def with_quant_mode(self, mode: str) -> "ArchConfig":
        return dataclasses.replace(self, quant=self.quant.with_mode(mode))

    def layer_plan(self) -> Plan:
        l = self.num_layers
        if self.family == "audio":
            return (("dec", l),)
        if self.family == "ssm":
            return (("mamba", l),)
        if self.family == "hybrid":
            if l % self.attn_every:
                raise ValueError("num_layers must be a multiple of "
                                 "attn_every")
            return (("hybrid_unit", l // self.attn_every),)
        if self.num_experts:
            plan = []
            if self.first_dense_layers:
                plan.append(("attn_mlp", self.first_dense_layers))
            plan.append(("attn_moe", l - self.first_dense_layers))
            return tuple(plan)
        return (("attn_mlp", l),)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (fp32 compute)."""
        small = dict(
            num_layers=min(self.num_layers, 4 if self.family != "hybrid"
                           else self.attn_every),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=256,
            vocab_size=256,
            head_dim=32,
            window=min(self.window, 64) if self.window else None,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            first_dense_layers=min(self.first_dense_layers, 1),
            dense_d_ff=256 if self.dense_d_ff else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_chunk=32,
            encoder_layers=min(self.encoder_layers, 2),
            frontend_dim=min(self.frontend_dim, 16) if self.frontend_dim
            else 0,
            dtype="float32",
            param_dtype="float32",
            q_block=64,
            name=self.name + "-reduced",
        )
        if self.mrope_sections:
            small["mrope_sections"] = (8, 4, 4)
        return dataclasses.replace(self, **small)
