"""Shared model components: norms, embeddings, rotary encodings.
Counterpart of ``repro.models.common``. The norm gains and the embedding
table are parameters (frozen until training asks for gradients).

The RMS mean follows the port's row-reduction rule (``core.numerics``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.numerics import sum_fp64


def rms_norm_init(d: int, *, device=None) -> Dict:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(g: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = sum_fp64("...d,...d->...", xf, xf,
                   divisor=xf.shape[-1])[..., None]
    y = xf * torch.rsqrt(var + eps)
    return (y * g.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, leaf: Dict):
        super().__init__()
        self.g = nn.Parameter(leaf["g"], requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rms_norm(self.g, x, eps)

    def tree(self) -> Dict:
        return {"g": self.g}


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Rows of the table in the compute dtype (gathered, then cast; the
    gather's backward sums repeated rows in a fixed order)."""
    return F.embedding(tokens, table).to(compute_dtype)


def embed_logits(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied readout: x [..., D] @ table.T -> fp32 [..., V]."""
    return torch.matmul(x.float(), table.float().t())


class Embed(nn.Module):
    def __init__(self, leaf: Dict):
        super().__init__()
        self.table = nn.Parameter(leaf["table"], requires_grad=False)

    def tree(self) -> Dict:
        return {"table": self.table}


# ------------------------------------------------------------------ RoPE ----
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64 (cast to fp32 where applied)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, S] -> fp32 (cos, sin) [B, S, 1, head_dim / 2]."""
    freqs = torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                            device=positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [B, S, H, Dh] by the tables of its positions (half-split
    layout): the reference's ``apply_rope``, with the tables computed once
    per step and shared by every layer."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` op by op in x's dtype, as
    ``jax.nn.silu`` lowers: in bf16 each of the four ops rounds, where the
    fused ``F.silu`` rounds once and often lands one bf16 step off."""
    return x * (1 / (1 + torch.exp(-x)))


def activation(name: str):
    return {"silu": silu,
            "gelu": lambda v: F.gelu(v, approximate="tanh"),
            "relu": F.relu}[name]
