"""Fused activation-quant segment GEMMs (B1, B2) and their plain versions.

Counterpart of ``repro.kernels.packed_matmul``: one uniform-precision
segment per call, x [M, Kp] @ unpack_dequant(wp [Kp*p//8, N]) * wscale
with the activation fake-quant fused into the prologue,

    xq = round_through_x_dtype(snap_p(x / sx) * sx),

accumulated in fp32 into ``out`` [M, N]. ``fused_act_segment_matmul``
takes the per-token scale ``sx`` from the driver (B1); the self-scale form
computes it over the full row (B2, legal when one segment spans K).

On CUDA tensors the wrappers launch ``csrc/segment_gemm.cu`` or raise; on
CPU tensors they run the plain versions below, which repeat the element
ops in torch and sum by the port's row-reduction rule (``core.numerics``:
float64, one rounding), so the CUDA kernel's fp32 sum is held against a
reference within rounding of the exact one.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core import pack, quant
from repro_torch.core.numerics import sum_fp64
from repro_torch.core.qtypes import GROUP_SIZE

from . import _build

SOURCE = "segment_gemm.cu"

# Launches of each CUDA kernel in this process (plain-version calls do not
# count); reset by whoever reads them.
LAUNCHES: Dict[str, int] = {"fused_act_segment_matmul": 0,
                            "fused_act_selfscale_matmul": 0}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.soniq_segment_gemm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


# ------------------------------------------------------------ plain ops ----
def act_quant(x: torch.Tensor, sx: torch.Tensor, p: int) -> torch.Tensor:
    """The prologue: fp32 ``round_through_x_dtype(snap_p(x / sx) * sx)``."""
    sx = sx.float().reshape(-1, 1)
    return (quant.snap_to_grid(x.float() / sx, p) * sx).to(x.dtype).float()


def unpack_dequant(wp: torch.Tensor, p: int,
                   scales: Optional[torch.Tensor] = None,
                   group_size: int = GROUP_SIZE) -> torch.Tensor:
    """[Kp*p//8, N] uint8 -> fp32 [Kp, N] grid values times the group
    scales."""
    kp = wp.shape[0] * (8 // p)
    wd = pack.dequant_codes(pack.unpack_codes(wp, p, kp), p)
    if scales is not None:
        wd = wd * quant.expand_groups(scales.float(), kp, group_size)[:, None]
    return wd


def plain_matmul(xq: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """fp32 [M, K] @ [K, N] summed in float64, rounded once to fp32."""
    return sum_fp64("mk,kn->mn", xq, wd)


def segment_matmul_plain(x, wp, scales=None, *, p: int,
                         group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Plain segment GEMM without activation quantization (the second pass
    of the two-pass form): x [M, Kp] @ unpack_dequant(wp) -> fp32."""
    return plain_matmul(x.float(), unpack_dequant(wp, p, scales, group_size))


def fused_act_segment_matmul_plain(x, sx, wp, scales=None, *, p: int,
                                   group_size: int = GROUP_SIZE
                                   ) -> torch.Tensor:
    """Plain version of B1: prologue, then the fp32 segment GEMM."""
    return plain_matmul(act_quant(x, sx, p),
                        unpack_dequant(wp, p, scales, group_size))


def fused_act_selfscale_matmul_plain(x, wp, scales=None, *, p: int,
                                     group_size: int = GROUP_SIZE
                                     ) -> torch.Tensor:
    """Plain version of B2: the per-token abs-max scale over the full row
    (``quant.abs_max_scale``), then B1."""
    sx = quant.abs_max_scale(x, dim=-1)
    return fused_act_segment_matmul_plain(x, sx, wp, scales, p=p,
                                          group_size=group_size)


# ------------------------------------------------------------- wrappers ----
def _prepare(x, wp, scales, out, p):
    if x.dim() != 2 or wp.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and wp {tuple(wp.shape)} "
                         "must be 2-D")
    m, kp = x.shape
    if p not in (1, 2, 4) or wp.shape[0] * (8 // p) != kp:
        raise ValueError(f"wp {tuple(wp.shape)} does not carry {kp} "
                         f"channels at p={p}")
    n = wp.shape[1]
    if out is None:
        out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    elif out.shape != (m, n) or out.dtype != torch.float32:
        raise ValueError(f"out must be fp32 [{m}, {n}], got "
                         f"{out.dtype} {tuple(out.shape)}")
    return out


def _launch(x, sx, wp, scales, out, *, p, group_size, self_scale):
    dev = x.device
    for name, t in (("sx", sx), ("wp", wp), ("scales", scales),
                    ("out", out)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be fp32 or bf16, got {x.dtype}")
    if x.shape[0] and x.shape[1] and x.stride(1) != 1:
        raise ValueError("x needs a unit column stride")
    if wp.dtype != torch.uint8 or not wp.is_contiguous():
        raise ValueError("wp must be contiguous uint8")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    m, kp = x.shape
    n = wp.shape[1]
    if sx is not None:
        if sx.dtype != torch.float32 or sx.numel() != m \
                or not sx.is_contiguous():
            raise ValueError("sx must be a contiguous fp32 [M, 1] tensor")
    if scales is not None:
        if scales.dtype != torch.float32 or not scales.is_contiguous() \
                or scales.numel() * group_size < kp:
            raise ValueError("scales must be contiguous fp32 [Kp // group]")
    if m == 0 or n == 0:
        return out
    lib = _build.library(SOURCE, _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.soniq_segment_gemm(
            x.data_ptr(), x.stride(0), int(x.dtype == torch.bfloat16),
            None if sx is None else sx.data_ptr(), wp.data_ptr(),
            None if scales is None else scales.data_ptr(), out.data_ptr(),
            m, n, kp, p, group_size, int(self_scale), stream)
    _build.check(code, "soniq_segment_gemm")
    key = ("fused_act_selfscale_matmul" if self_scale
           else "fused_act_segment_matmul")
    LAUNCHES[key] += 1
    return out


def fused_act_segment_matmul(x: torch.Tensor, sx: torch.Tensor,
                             wp: torch.Tensor,
                             scales: Optional[torch.Tensor] = None, *,
                             p: int, group_size: int = GROUP_SIZE,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """B1: ``out += xq @ unpack_dequant(wp)`` with the driver's per-token
    scale ``sx`` [M, 1]; ``out`` is a fresh zero [M, N] fp32 tensor when
    not given. x may be a column slice of a wider row (unit column
    stride)."""
    out = _prepare(x, wp, scales, out, p)
    if x.device.type == "cpu":
        return out.add_(fused_act_segment_matmul_plain(
            x, sx, wp, scales, p=p, group_size=group_size))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, sx, wp, scales, out, p=p, group_size=group_size,
                   self_scale=False)


def fused_act_selfscale_matmul(x: torch.Tensor, wp: torch.Tensor,
                               scales: Optional[torch.Tensor] = None, *,
                               p: int, group_size: int = GROUP_SIZE,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """B2: B1 with the per-token scale ``max(max|x_row|, 1e-6) / 1.875``
    computed in the kernel over the full row (one segment spans K)."""
    out = _prepare(x, wp, scales, out, p)
    if x.device.type == "cpu":
        return out.add_(fused_act_selfscale_matmul_plain(
            x, wp, scales, p=p, group_size=group_size))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, None, wp, scales, out, p=p, group_size=group_size,
                   self_scale=True)
