"""Shared model components: norms, embeddings, rotary encodings and the
encoder-decoder's fixed sinusoidal positions. Counterpart of
``repro.models.common`` (and of ``repro.models.lm._sinusoid_at``). The
norm gains and biases and the embedding table are parameters (frozen
until training asks for gradients).

The RMS and LayerNorm means follow the port's row-reduction rule
(``core.numerics``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def layer_norm_init(d: int, *, device=None) -> Dict:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def layer_norm(g: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32: the row mean and the variance of the centred row
    (float64 sums, one rounding each), ``rsqrt``, gain and bias, cast back
    to x's dtype."""
    xf = x.float()
    d = xf.shape[-1]
    mu = sum_fp64("...d->...", xf, divisor=d)[..., None]
    xc = xf - mu
    var = sum_fp64("...d,...d->...", xc, xc, divisor=d)[..., None]
    y = xc * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, leaf: Dict):
        super().__init__()
        self.g = nn.Parameter(leaf["g"], requires_grad=False)
        self.b = nn.Parameter(leaf["b"], requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return layer_norm(self.g, self.b, x, eps)

    def tree(self) -> Dict:
        return {"g": self.g, "b": self.b}


def norm_init(cfg, *, device=None) -> Dict:
    """The leaf of the config's norm (``cfg.norm``: "rms" or "ln")."""
    if cfg.norm == "ln":
        return layer_norm_init(cfg.d_model, device=device)
    if cfg.norm == "rms":
        return rms_norm_init(cfg.d_model, device=device)
    raise ValueError(f"unknown norm {cfg.norm!r}")


def norm_module(leaf: Dict) -> nn.Module:
    """The norm a leaf holds: LayerNorm with a bias, RMSNorm without."""
    return LayerNorm(leaf) if "b" in leaf else RMSNorm(leaf)


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


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, S], or [3, B, S] for M-RoPE -> fp32 (cos, sin) [B, S,
    1, head_dim / 2]. M-RoPE splits the head_dim / 2 frequencies into
    ``mrope_sections`` (temporal, height, width) and takes each section's
    angles from its own position stream, concatenated in that order, as
    the reference's ``apply_rope`` does: with three equal streams the
    tables are bitwise the [B, S] tables (each angle is the same fp32
    product)."""
    freqs = torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                            device=positions.device)
    if positions.dim() == 2:
        ang = positions.float()[..., None] * freqs
    else:
        if mrope_sections is None or positions.shape[0] != 3:
            raise ValueError(f"positions {tuple(positions.shape)} need three "
                             f"streams and mrope_sections")
        if sum(mrope_sections) != head_dim // 2:
            raise ValueError(f"mrope_sections {mrope_sections} do not sum to "
                             f"head_dim / 2 = {head_dim // 2}")
        parts, off = [], 0
        for stream, sec in zip(positions, mrope_sections):
            parts.append(stream.float()[..., None] * freqs[off:off + sec])
            off += sec
        ang = torch.cat(parts, dim=-1)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [B, S, H, Dh] by the tables of its positions (half-split
    layout): the reference's ``apply_rope``, with the tables computed once
    per step and shared by every layer."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------- sinusoid positions ----
def sinusoid_positions(max_len: int, d: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings [max_len, d] fp32 (the
    encoder's): computed in float64 with numpy and rounded once, as the
    reference computes them, so bitwise the reference's."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (1e4 ** (dim / d))
    out = np.zeros((max_len, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


def sinusoid_denominators(d: int) -> np.ndarray:
    """fp32 ``1e4 ** (dim / d)`` over dim = 0, 2, ..., d - 2: the exponent
    an fp32 division, the power taken in float64 and rounded once (equal
    to the reference's fp32 ``pow`` at every entry it was checked at,
    where torch's fp32 ``pow`` is not)."""
    expo = np.arange(0, d, 2).astype(np.float32) / np.float32(d)
    return (1e4 ** expo.astype(np.float64)).astype(np.float32)


def sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """The decoder's sinusoidal embedding at arbitrary positions: pos
    [...] (int) -> fp32 [..., d], sin at even and cos at odd channels.
    The angle is the position times the fp32 reciprocal of its
    denominator, as XLA computes the reference's division by that
    constant; its sin and cos are taken in float64 and rounded once (the
    reference's XLA fp32 sin and cos are no formula: they differ from the
    correctly rounded values in ~1% of entries, by one rounding)."""
    recip = np.float32(1.0) / sinusoid_denominators(d)
    ang = (pos.float()[..., None]
           * torch.as_tensor(recip, device=pos.device)).double()
    out = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return out.reshape(pos.shape + (d,)).float()


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


def _tanh_forward(x: torch.Tensor) -> torch.Tensor:
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


def _tanh_vjp(g: torch.Tensor, ans: torch.Tensor) -> torch.Tensor:
    """JAX's tanh derivative, ``(g + g * ans) * (1 - ans)`` on the rounded
    output ``ans``, transposed as XLA computes it: ``w = g * (1 - ans)``,
    then ``w + w * ans``, one multiply-add in fp32 (XLA's CPU lowering
    contracts it), op by op in bf16."""
    w = g * (1 - ans)
    if g.dtype == torch.float32:
        return _fma(w, ans, w)
    return w + w * ans


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _tanh_forward(x)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        return _tanh_vjp(g, ans)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh`` as XLA computes it on the CPU, in fp32, cast to x's
    dtype (torch's tanh differs in the last bits on more than half of all
    inputs), with JAX's derivative (autograd of the rational
    approximation would differentiate its polynomials, its clamp and its
    linear branch)."""
    return _Tanh.apply(x)


def _gelu_forward(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gelu(x), the tanh it took)."""
    x3 = x * x * x
    a = _const(GELU_A, x)
    if x.dtype == torch.float32:
        inner = _fma(x3, a, x)
    else:
        inner = x + a * x3
    t = _tanh_forward(_const(GELU_C, x) * inner)
    return x * (0.5 * (1.0 + t)), t


def _gelu_vjp(x: torch.Tensor, t: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """The reference's gelu gradient: ``jax.vjp`` of ``jax.nn.gelu`` in the
    order XLA's CPU lowering evaluates it. In fp32 the constant
    ``sqrt(2/pi) * 0.044715`` is folded into one fp32 product and two
    products are contracted into multiply-adds; in bf16 every op
    rounds."""
    c = _const(GELU_C, x)
    x2 = x * x
    cdf = (t + 1) * 0.5
    w = ((x * g) * 0.5) * (1 - t)
    if x.dtype == torch.float32:
        du = _fma(w, t, w)
        ca = _const(float(np.float32(GELU_C) * np.float32(GELU_A)), x)
        return _fma(du * ca, x2 * 3, _fma(g, cdf, du * c))
    du = w + w * t
    dc = du * c
    return (g * cdf + dc) + (dc * _const(GELU_A, x)) * (x2 * 3)


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out, t = _gelu_forward(x)
        ctx.save_for_backward(x, t)
        return out

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        return _gelu_vjp(x, t, g)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) op by op in x's dtype:
    ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))))``. In fp32
    XLA's CPU lowering fuses ``x + 0.044715 * x**3`` into one multiply-add,
    and so does this; in bf16 every op rounds. The gradient is the
    reference's (:func:`_gelu_vjp`)."""
    return _Gelu.apply(x)


def activation(name: str):
    return {"silu": silu, "gelu": gelu, "relu": F.relu}[name]
