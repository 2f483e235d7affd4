"""QAT quantize-dequantize along K (B8) and its plain version.

Counterpart of ``repro.kernels.fake_quant``: x is quantize-dequantized
along K with per-16-channel-group precisions ``pbits`` [K // 16] and either
a per-row scale (one value per index of the non-K dimension: dynamic
activation scaling) or a per-group scale [K // 16] (weight scaling):

    y = round_to_x_dtype(snap_p(x / s) * s).

``k_dim`` names the dimension of K: 1 for activations x [M, K] (the
reference's layout), 0 for a weight w [K, N], which the reference
quantizes as ``swapaxes(w)``; the kernel reads w in place instead of a
transposed copy, with the same arithmetic per element. The plain version
is ``core.quant.fake_quant_fwd`` on the reference's layout.

``fake_quant_bwd`` is the clipped straight-through backward, the
reference's custom VJP (``repro.backend.base._fake_quant_bwd``): dx = g *
in_range(x), the mask rebuilt from x with the forward's arithmetic, in x's
dtype, on every layout the forward takes (bitwise the plain version).

Expert banks: x [E, R, C] with pbits [E, K // 16] and each expert's own
scales (per group [E, K // 16], or per row: [E, non-K extent]) go through
the same wrappers, ``k_dim`` naming K among the last two dimensions; one
launch covers the bank and equals E calls on the slices bit for bit.

On CUDA tensors the wrappers launch ``csrc/fake_quant.cu`` or raise; on
CPU tensors they run the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core import quant
from repro_torch.core.qtypes import GROUP_SIZE

from . import _build

SOURCE = "fake_quant.cu"

# Launches of the CUDA kernel in this process (plain-version calls do not
# count); reset by whoever reads it.
LAUNCHES: Dict[str, int] = {"fake_quant": 0, "fake_quant_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.soniq_fake_quant.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                     i32, i32, i32, ptr]
    lib.soniq_fake_quant_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                         i32, i32, i32, i32, i32, ptr]
    lib.soniq_fake_quant.restype = i32
    lib.soniq_fake_quant_bwd.restype = i32


def _check(x: torch.Tensor, k_dim: int) -> int:
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be [R, C] or a bank [E, R, C], got "
                         f"{tuple(x.shape)}")
    if k_dim not in (0, 1):
        raise ValueError(f"k_dim must be 0 or 1, got {k_dim}")
    return k_dim


def _check_layout(x: torch.Tensor, pbits: torch.Tensor, scale: torch.Tensor,
                  row_scale: bool, k_dim: int, group_size: int) -> int:
    """k_dim, once pbits and scale are known to cover x's layout (a bank:
    one row of pbits and of scales an expert)."""
    kd = _check(x, k_dim)
    e = x.shape[0] if x.dim() == 3 else 1
    r, c = x.shape[-2:]
    k, m = (r, c) if kd == 0 else (c, r)
    if k % group_size or pbits.numel() * group_size != e * k or (
            x.dim() == 3 and pbits.shape[0] != e):
        raise ValueError(f"pbits {tuple(pbits.shape)} do not cover K={k} "
                         f"in groups of {group_size} for {e} slice(s)")
    if scale.numel() != e * (m if row_scale else k // group_size):
        raise ValueError(f"scale {tuple(scale.shape)} is neither one per "
                         f"row ({e} x {m}) nor one per group "
                         f"({e} x {k // group_size})")
    return kd


def _plain_operands(x, pbits, scale, row_scale, kd):
    """x on the reference's layout (K last), pbits and the scale shaped to
    broadcast against it."""
    xt = x if kd == 1 else x.transpose(-2, -1)
    pb = pbits.float().reshape(pbits.shape[0], -1) if x.dim() == 3 \
        else pbits.float()
    if row_scale:
        s = scale.float().reshape(xt.shape[:-1] + (1,))
    else:
        s = scale.float().reshape(pb.shape)
    return xt, pb, s


def fake_quant_plain(x: torch.Tensor, pbits: torch.Tensor,
                     scale: torch.Tensor, *, row_scale: bool, k_dim: int = 1,
                     group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Plain version on the reference's layout ([M, K]; a [K, N] weight is
    transposed there and back; a bank slice by slice, vectorized)."""
    kd = _check(x, k_dim)
    xt, pb, s = _plain_operands(x, pbits, scale, row_scale, kd)
    y = quant.fake_quant_fwd(xt, pb, s, group_size)
    return y if kd == 1 else y.transpose(-2, -1).contiguous()


def fake_quant_bwd_plain(x: torch.Tensor, pbits: torch.Tensor,
                         scale: torch.Tensor, g: torch.Tensor, *,
                         row_scale: bool, k_dim: int = 1,
                         group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Plain backward: g * the in-range mask, computed on the reference's
    layout (a [K, N] weight's mask transposed there and back)."""
    kd = _check(x, k_dim)
    xt, pb, s = _plain_operands(x, pbits, scale, row_scale, kd)
    mask = quant.fake_quant_in_range(xt, pb, s, group_size)
    return g * (mask if kd == 1 else mask.transpose(-2, -1))


def fake_quant(x: torch.Tensor, pbits: torch.Tensor, scale: torch.Tensor, *,
               row_scale: bool, k_dim: int = 1,
               group_size: int = GROUP_SIZE) -> torch.Tensor:
    """x [R, C] (fp32 or bf16) -> quantize-dequantized x, same dtype and
    shape. K is dimension ``k_dim``; ``scale`` holds one value per index of
    the other dimension when ``row_scale``, else one per group of K. A bank
    x [E, R, C] takes pbits [E, K // group_size] and E rows of scales."""
    kd = _check_layout(x, pbits, scale, row_scale, k_dim, group_size)
    if x.device.type == "cpu":
        return fake_quant_plain(x, pbits, scale, row_scale=row_scale,
                                k_dim=kd, group_size=group_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"x must be contiguous fp32 or bf16, got "
                         f"{x.dtype}")
    pb = pbits.float().contiguous()
    sc = scale.float().contiguous()
    if pb.device != x.device or sc.device != x.device:
        raise ValueError("pbits and scale must lie on x's device")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.library(SOURCE, _bind)
    e = x.shape[0] if x.dim() == 3 else 1
    code = _build.launch(
        x.device, lib.soniq_fake_quant, x.data_ptr(), pb.data_ptr(),
        sc.data_ptr(), out.data_ptr(), e, x.shape[-2], x.shape[-1],
        group_size, int(kd == 0), int(row_scale), _DTYPES[x.dtype])
    _build.check(code, "soniq_fake_quant")
    LAUNCHES["fake_quant"] += 1
    return out


def fake_quant_bwd(x: torch.Tensor, pbits: torch.Tensor, scale: torch.Tensor,
                   g: torch.Tensor, *, row_scale: bool, k_dim: int = 1,
                   group_size: int = GROUP_SIZE) -> torch.Tensor:
    """The clipped straight-through backward of :func:`fake_quant` at x
    for the cotangent g: dx = g * in_range(x), x's dtype and shape. On
    CUDA, x and g must be contiguous and of one dtype (fp32 or bf16), and
    pbits and scale contiguous fp32, all on x's device."""
    kd = _check_layout(x, pbits, scale, row_scale, k_dim, group_size)
    if x.device.type == "cpu":
        return fake_quant_bwd_plain(x, pbits, scale, g, row_scale=row_scale,
                                    k_dim=kd, group_size=group_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be fp32 or bf16, got {x.dtype}")
    f32 = torch.float32
    for t, dt in ((x, x.dtype), (g, x.dtype), (pbits, f32), (scale, f32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"operand {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} must be contiguous {dt} on "
                             f"{x.device}")
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} is not x's {tuple(x.shape)}")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    lib = _build.library(SOURCE, _bind)
    e = x.shape[0] if x.dim() == 3 else 1
    code = _build.launch(
        x.device, lib.soniq_fake_quant_bwd, x.data_ptr(), g.data_ptr(),
        pbits.data_ptr(), scale.data_ptr(), dx.data_ptr(), e, x.shape[-2],
        x.shape[-1], group_size, int(kd == 0), int(row_scale),
        _DTYPES[x.dtype])
    _build.check(code, "soniq_fake_quant_bwd")
    LAUNCHES["fake_quant_bwd"] += 1
    return dx
