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


# XLA's CPU tanh for fp32 (Eigen's rational approximation, evaluated with
# fused multiply-adds): the input clamped to +-TANH_CLAMP, odd numerator
# and even denominator polynomials in x^2, and x itself below
# TANH_LINEAR.
TANH_CLAMP = 7.99881172180175781
TANH_LINEAR = 0.0004
TANH_NUM = tuple(float(np.float32(c)) for c in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03))
TANH_DEN = tuple(float(np.float32(c)) for c in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03))
GELU_C = np.sqrt(2 / np.pi)
GELU_A = 0.044715


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """fp32 ``a * b + c`` (c an fp32 value or tensor) rounded once: the
    product of two fp32 values is exact in float64 and the sum is rounded
    to float64 first, which can differ from one rounding only on an exact
    fp32 tie."""
    return (a.double() * b.double() + c).float()


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    """A constant in x's dtype, as JAX casts a weakly typed one."""
    return torch.tensor(c, dtype=like.dtype, device=like.device)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh`` as XLA computes it on the CPU, in fp32, cast to x's
    dtype (torch's tanh differs in the last bits on more than half of all
    inputs)."""
    xf = x.float()
    c = torch.clamp(xf, -TANH_CLAMP, TANH_CLAMP)
    c2 = c * c
    num = torch.full_like(c2, TANH_NUM[0])
    for coef in TANH_NUM[1:]:
        num = _fma(c2, num, coef)
    den = torch.full_like(c2, TANH_DEN[0])
    for coef in TANH_DEN[1:]:
        den = _fma(c2, den, coef)
    out = (c * num) / den
    return torch.where(xf.abs() < TANH_LINEAR, xf, out).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) op by op in x's dtype:
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))))``. In fp32
    XLA's CPU lowering fuses ``x + 0.044715 * x**3`` into one multiply-add,
    and so does this; in bf16 every op rounds."""
    x3 = x * x * x
    a = _const(GELU_A, x)
    if x.dtype == torch.float32:
        inner = _fma(x3, a, x)
    else:
        inner = x + a * x3
    return x * (0.5 * (1.0 + tanh(_const(GELU_C, x) * inner)))


def activation(name: str):
    return {"silu": silu, "gelu": gelu, "relu": F.relu}[name]
