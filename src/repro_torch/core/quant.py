"""The SMOL/SONIQ grid (serve subset). Counterpart of ``repro.core.quant``.

An n-bit code u represents v = (2u - (2^n - 1)) * 2^(1-n): the odd
multiples of 2^(1-n) in ±(2 - 2^(1-n)). Rounding is half-to-even
(``torch.round``, like ``jnp.round``), and every division by a scale is an
IEEE division by a tensor — PyTorch's CUDA ``div`` multiplies by the
reciprocal when the divisor is a Python scalar, which is one ulp off.
"""
from __future__ import annotations

import torch

# Floor on any dynamic abs-max before it becomes a divisor: all-zero rows
# (padding lanes, freshly reset cache slots) get a tiny finite scale.
ACT_SCALE_EPS = 1e-6


def static_grid_max(p: int) -> float:
    """Largest magnitude of the p-bit grid: 2 - 2^(1-p)."""
    return 2.0 - 2.0 ** (1 - p)


def _as_f32(p, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(p, dtype=torch.float32, device=like.device)


def quantize_to_int(x: torch.Tensor, p) -> torch.Tensor:
    """x (already scaled into ±2) -> unsigned codes u (float), branchless
    in ``p`` (a number or a tensor broadcast against x)."""
    x = x.float()
    p = _as_f32(p, x)
    h = torch.exp2(1.0 - p)                 # 2^(1-p): half step
    two_p = 2.0 / h                         # 2^p
    u = torch.round((x / h + (two_p - 1.0)) / 2.0)
    return torch.minimum(torch.clamp_min(u, 0.0), two_p - 1.0)


def dequantize_int(u: torch.Tensor, p) -> torch.Tensor:
    """Unsigned codes -> grid values, branchless in ``p``."""
    u = u.float()
    p = _as_f32(p, u)
    h = torch.exp2(1.0 - p)
    two_p = 2.0 / h
    return (2.0 * u - (two_p - 1.0)) * h


def snap_to_grid(x: torch.Tensor, p) -> torch.Tensor:
    """Round scaled x to the nearest p-bit grid point (with clipping)."""
    return dequantize_int(quantize_to_int(x, p), p)


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE ``x / c`` for a constant c on any device (see module note)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def abs_max_scale(x: torch.Tensor, dim=None, grid_p: int = 4,
                  eps: float = ACT_SCALE_EPS) -> torch.Tensor:
    """Dynamic scale mapping abs-max of x to the top of the 4-bit grid:
    ``max(max|x|, eps) / 1.875`` (keepdims)."""
    a = x.float().abs()
    m = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    if dim is None:
        m = m.reshape([1] * x.dim())
    return div_const(torch.clamp_min(m, eps), static_grid_max(grid_p))


def per_group_weight_scale(w: torch.Tensor, group_size: int = 16,
                           grid_p: int = 4,
                           eps: float = ACT_SCALE_EPS) -> torch.Tensor:
    """Per-(K group) scale for a [K, ...] weight -> [K // group_size]."""
    k = w.shape[0]
    m = w.float().abs().reshape(k // group_size, group_size, -1).amax(
        dim=(1, 2))
    return div_const(torch.clamp_min(m, eps), static_grid_max(grid_p))


def expand_groups(v: torch.Tensor, k: int, group_size: int) -> torch.Tensor:
    """[K // G] per-group values -> [K] per-channel values."""
    return torch.repeat_interleave(v, group_size, dim=-1)[..., :k]


def fake_quant_fwd(x: torch.Tensor, pbits, scale,
                   group_size: int = 16) -> torch.Tensor:
    """Forward of the clipped-STE fake quantization along the last dim
    (``repro.core.quant._fake_quant_fwd_impl``): divide by the scale,
    snap each group to its precision, rescale, round through x's dtype.
    ``scale`` broadcasts against x, or is per-group [K // group_size]."""
    k = x.shape[-1]
    p = expand_groups(torch.as_tensor(pbits, device=x.device).float(),
                      k, group_size)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if s.dim() and s.shape[-1] == max(1, k // group_size) \
            and k > s.shape[-1]:
        s = expand_groups(s, k, group_size)
    xs = x.float() / s
    return (snap_to_grid(xs, p) * s).to(x.dtype)
