"""Feed-forward block (SwiGLU / GELU), every matmul a SmolLinear.
Counterpart of ``repro.models.mlp``."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core import smol
from repro_torch.core.qtypes import QuantConfig
from .common import activation, silu


def mlp_init(d_model: int, d_ff: int, qcfg: QuantConfig, *, generator,
             device, act: str = "swiglu", use_bias: bool = False,
             dtype=torch.float32) -> Dict:
    kw = dict(generator=generator, device=device, use_bias=use_bias,
              dtype=dtype)
    p = {"up": smol.linear_init(d_model, d_ff, qcfg, **kw),
         "down": smol.linear_init(d_ff, d_model, qcfg, **kw)}
    if act == "swiglu":
        p["gate"] = smol.linear_init(d_model, d_ff, qcfg, **kw)
    return p


class MLP(nn.Module):
    def __init__(self, tree: Dict, act: str = "swiglu"):
        super().__init__()
        self.act = act
        self.up = smol.SmolLinear(tree["up"])
        self.down = smol.SmolLinear(tree["down"])
        self.gate = smol.SmolLinear(tree["gate"]) if act == "swiglu" \
            else None

    def forward(self, x: torch.Tensor, qcfg: QuantConfig,
                noise: Optional[smol.NoiseSource] = None) -> torch.Tensor:
        h = self.up(x, qcfg, noise)
        if self.act == "swiglu":
            h = silu(self.gate(x, qcfg, noise)) * h
        else:
            h = activation(self.act)(h)
        return self.down(h, qcfg, noise)

    def tree(self) -> Dict:
        out = {"up": self.up.leaf(), "down": self.down.leaf()}
        if self.gate is not None:
            out["gate"] = self.gate.leaf()
        return out
