"""The SMOL/SONIQ grid and straight-through fake quantization.
Counterpart of ``repro.core.quant``.

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
    """Per-(K group) scale for a [K, N] weight -> [K // group_size]; for a
    stacked bank [E, K, N] each expert's own -> [E, K // group_size] (the
    reference's function under ``vmap``)."""
    k = w.shape[-2] if w.dim() == 3 else w.shape[0]
    lead = tuple(w.shape[:-2]) if w.dim() == 3 else ()
    m = w.float().abs().reshape(lead + (k // group_size, group_size, -1)
                                ).amax(dim=(-2, -1))
    return div_const(torch.clamp_min(m, eps), static_grid_max(grid_p))


def expand_groups(v: torch.Tensor, k: int, group_size: int) -> torch.Tensor:
    """[..., K // G] per-group values -> [..., K] per-channel values."""
    return torch.repeat_interleave(v, group_size, dim=-1)[..., :k]


def _channels(v: torch.Tensor, x: torch.Tensor, group_size: int
              ) -> torch.Tensor:
    """Per-group values over x [..., K]'s channels: [K // G] -> [K]; a
    bank's [E, K // G] against x [E, R, K] -> [E, 1, K]."""
    v = expand_groups(v, x.shape[-1], group_size)
    return v.unsqueeze(-2) if 2 <= v.dim() < x.dim() else v


def _fake_quant_operands(x: torch.Tensor, pbits, scale, group_size: int):
    k = x.shape[-1]
    p = _channels(torch.as_tensor(pbits, device=x.device).float(), x,
                  group_size)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if s.dim() and s.shape[-1] == max(1, k // group_size) \
            and k > s.shape[-1]:
        s = _channels(s, x, group_size)
    return x.float() / s, p, s


def fake_quant_fwd(x: torch.Tensor, pbits, scale,
                   group_size: int = 16) -> torch.Tensor:
    """Forward of the clipped-STE fake quantization along the last dim
    (``repro.core.quant._fake_quant_fwd_impl``): divide by the scale,
    snap each group to its precision, rescale, round through x's dtype.
    ``scale`` broadcasts against x, or is per-group [K // group_size]."""
    xs, p, s = _fake_quant_operands(x, pbits, scale, group_size)
    return (snap_to_grid(xs, p) * s).to(x.dtype)


def fake_quant_in_range(x: torch.Tensor, pbits, scale,
                        group_size: int = 16) -> torch.Tensor:
    """The clipped-STE mask in x's dtype: 1 where |x / scale| lies inside
    its group's grid range 2 - 2^(1-p), else 0."""
    xs, p, _s = _fake_quant_operands(x, pbits, scale, group_size)
    return (xs.abs() <= 2.0 - torch.exp2(1.0 - p)).to(x.dtype)


class _FakeQuantSTE(torch.autograd.Function):
    """Plain fake quantization with the clipped straight-through
    gradient: dx = g * in_range; pbits and scale get none."""

    @staticmethod
    def forward(ctx, x, pbits, scale, group_size):
        ctx.save_for_backward(x, pbits, scale)
        ctx.group_size = group_size
        return fake_quant_fwd(x, pbits, scale, group_size)

    @staticmethod
    def backward(ctx, g):
        x, pbits, scale = ctx.saved_tensors
        return (g * fake_quant_in_range(x, pbits, scale, ctx.group_size),
                None, None, None)


def fake_quant(x: torch.Tensor, pbits, scale,
               group_size: int = 16) -> torch.Tensor:
    """Differentiable fake quantization (``repro.core.quant.fake_quant``)
    in plain torch: the forward of :func:`fake_quant_fwd`, the clipped
    STE backward."""
    pbits = torch.as_tensor(pbits, dtype=torch.float32, device=x.device)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _FakeQuantSTE.apply(x, pbits, scale, group_size)
