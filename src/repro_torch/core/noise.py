"""Phase I of SONIQ: noise-injected precision search (paper Alg. 1/2).
Counterpart of ``repro.core.noise``.

Per (layer, input-channel group) a trainable logit ``s`` sets the
perturbation scale sigma(s) = 1 / (1 + e^-s), which equals the worst-case
round-off 2^(1-p) of a p-bit SMOL number, so

    bits(s) = 1 + log2(1 + e^-s)

is a differentiable bit count and the paper's regularizer is
lambda * sum(bits(s) - 1). One s per input-channel group is shared by the
weights and by the activations that multiply them (Obs. 3); precisions
snap to {1, 2, 4} (Obs. 2).

The reference draws the activation noise from ``jax.random``; here the
caller hands the draw ``eps`` in (``core.smol.NoiseDraw``), so a test can
replay the reference's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from .qtypes import GROUP_SIZE
from .quant import div_const


def s_init(p_init: int) -> float:
    """s_init = -ln(2^(p-1) - 1); for p = 1 the exact value is +inf, so a
    large finite logit (sigma within 1e-3 of 1)."""
    if p_init <= 1:
        return 8.0
    return float(-np.log(2.0 ** (p_init - 1) - 1.0))


def init_s(num_groups: int, p_init: int = 4, *, device=None) -> torch.Tensor:
    return torch.full((num_groups,), s_init(p_init), dtype=torch.float32,
                      device=device)


def sigma(s: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(s.float())


def bits_soft(s: torch.Tensor) -> torch.Tensor:
    """Differentiable bit count 1 + log2(1 + e^-s) = 1 + softplus(-s) /
    ln 2 (an IEEE division by the fp32 ln 2, as the reference divides)."""
    return 1.0 + div_const(torch.nn.functional.softplus(-s.float()),
                           np.log(2.0))


def bit_penalty(s: torch.Tensor) -> torch.Tensor:
    """The paper's L1 regularizer || log2(1 + e^-s) ||_1 (sum over s)."""
    return torch.sum(bits_soft(s) - 1.0)


def precision_from_s(s: torch.Tensor) -> torch.Tensor:
    """Readout p = 1 + round(log2(1 + e^-s)) (paper Alg. 1 line 9)."""
    return 1.0 + torch.round(bits_soft(s) - 1.0)


def snap_124(p: torch.Tensor) -> torch.Tensor:
    """Closest precision in {1, 2, 4}, ties toward more bits (paper Alg. 2
    line 11): raw p in [2.5, 3) rounds to 3 and snaps to 4."""
    p = p.float()
    return torch.where(p >= 2.5, torch.full_like(p, 4.0),
                       torch.where(p >= 1.5, torch.full_like(p, 2.0),
                                   torch.ones_like(p)))


# Thresholds on s for the {4, 2, 1}-bit bands (the inverse of the
# round-then-snap readout, used by PatternMatch, paper Alg. 3): s < T_4B
# -> 4 bits; s < T_2B -> 2 bits; else 1 bit.
T_4B = float(-np.log(2.0 ** 1.5 - 1.0))   # raw p = 2.5
T_2B = float(-np.log(np.sqrt(2) - 1.0))   # raw p = 1.5
# Representative logits PatternMatch assigns (s_init of each precision).
S_4B, S_2B, S_1B = s_init(4), s_init(2), s_init(1)


def _per_channel(s: torch.Tensor, k: int, group_size: int) -> torch.Tensor:
    """sigma(s) per channel: [..., K // G] -> [..., K]."""
    return torch.repeat_interleave(sigma(s), group_size, dim=-1)[..., :k]


def inject_act_noise(x: torch.Tensor, s: torch.Tensor, eps: torch.Tensor,
                     scale=1.0, group_size: int = GROUP_SIZE
                     ) -> torch.Tensor:
    """x + scale * sigma(s) * eps along the last dim of x (paper Alg. 2
    line 6), in x's dtype; ``eps`` ~ U(-1, 1) has x's shape and ``scale``
    is the activation quantization scale, so the noise is in activation
    units. An expert bank's x [E, C, K] takes each expert's logits s
    [E, K // G] (and a scale that broadcasts per expert, e.g. [E, 1, 1])."""
    sig = _per_channel(s, x.shape[-1], group_size).to(x.dtype)
    if s.dim() == 2:
        sig = sig[:, None, :]
    scale = torch.as_tensor(scale, device=x.device).to(x.dtype)
    return x + scale * sig * eps.to(x.dtype)


def clip_weights(w: torch.Tensor, s: torch.Tensor,
                 group_size: int = GROUP_SIZE) -> torch.Tensor:
    """The projection after the optimizer update (paper Alg. 1 line 7):
    clip w [K, ...] to +-(2 - sigma(s)) per K group; a bank w [E, K, N]
    with s [E, K // G] per expert."""
    if s.dim() == 2:
        lim = (2.0 - _per_channel(s, w.shape[-2], group_size))[..., None]
    else:
        k = w.shape[0]
        lim = (2.0 - _per_channel(s, k, group_size)).reshape(
            (k,) + (1,) * (w.dim() - 1))
    lim = lim.to(w.dtype)
    return torch.minimum(torch.maximum(w, -lim), lim)
