"""Segment GEMMs (B1, B2, B3, B6) and their plain versions.

Counterpart of ``repro.kernels.packed_matmul``: one uniform-precision
segment per call, x [M, Kp] @ unpack_dequant(wp [Kp*p//8, N]) * wscale,
accumulated in fp32 into ``out`` [M, N]. The fused forms quantize the
activations in the prologue,

    xq = round_through_x_dtype(snap_p(x / sx) * sx),

with the per-token scale ``sx`` from the driver (B1,
``fused_act_segment_matmul``) or computed over the full row (B2, the
self-scale form, legal when one segment spans K). The plain form (B3,
``packed_segment_matmul``) takes x as it is, or snapped to the grid when
``act_quant`` (x already in scale units): the second pass of the two-pass
form. The grouped form (B6, ``packed_segment_matmul_grouped``) is B3 over
a stacked expert bank, x [E, M, Kp] @ wp [E, Kp*p//8, N] -> [E, M, N].
All four are one CUDA kernel body with a mode, so they share one order of
accumulation.

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
                            "fused_act_selfscale_matmul": 0,
                            "packed_segment_matmul": 0,
                            "packed_segment_matmul_grouped": 0}

# Prologue modes of the kernel (csrc/segment_gemm.cu).
FUSED, SELF, PLAIN, SNAP = 0, 1, 2, 3


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.soniq_segment_gemm
    ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [vp, ll, ll, i, vp, vp, ll, vp, ll, vp, ll,
                   i, i, i, i, i, i, i, vp]
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
                         act_quant: bool = False,
                         group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Plain version of B3: x [M, Kp] (snapped to the p-bit grid first
    when ``act_quant``: x is already in scale units) @ unpack_dequant(wp)
    -> fp32."""
    xs = x.float()
    if act_quant:
        xs = quant.snap_to_grid(xs, p)
    return plain_matmul(xs, unpack_dequant(wp, p, scales, group_size))


def grouped_matmul_plain(x, wp, scales=None, *, p: int,
                         act_quant: bool = False,
                         group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Plain version of B6: B3's plain version per expert, x [E, M, Kp],
    wp [E, Kp*p//8, N], scales [E, Kp // group_size] or None ->
    fp32 [E, M, N]."""
    return torch.stack([segment_matmul_plain(
        x[e], wp[e], None if scales is None else scales[e], p=p,
        act_quant=act_quant, group_size=group_size)
        for e in range(x.shape[0])])


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
    """Shapes of a launch: ``x`` [(E,) M, Kp] against ``wp`` [(E,)
    Kp*p//8, N]; returns ``out`` (a fresh zero fp32 [(E,) M, N] when not
    given)."""
    grouped = x.dim() == 3
    if x.dim() not in (2, 3) or wp.dim() != x.dim():
        raise ValueError(f"x {tuple(x.shape)} and wp {tuple(wp.shape)} "
                         "must both be 2-D (one segment) or 3-D (experts)")
    kp = x.shape[-1]
    if p not in (1, 2, 4) or wp.shape[-2] * (8 // p) != kp:
        raise ValueError(f"wp {tuple(wp.shape)} does not carry {kp} "
                         f"channels at p={p}")
    if grouped and wp.shape[0] != x.shape[0]:
        raise ValueError(f"x has {x.shape[0]} experts, wp {wp.shape[0]}")
    shape = tuple(x.shape[:-1]) + (wp.shape[-1],)
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=x.device)
    elif tuple(out.shape) != shape or out.dtype != torch.float32:
        raise ValueError(f"out must be fp32 {list(shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    return out


def _launch(x, sx, wp, scales, out, *, p, group_size, mode, key):
    """One launch over E experts (a 2-D x is one expert)."""
    dev = x.device
    for name, t in (("sx", sx), ("wp", wp), ("scales", scales),
                    ("out", out)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be fp32 or bf16, got {x.dtype}")
    x3, wp3, out3 = (t if t.dim() == 3 else t[None] for t in (x, wp, out))
    e, m, kp = x3.shape
    n = wp3.shape[-1]
    if x.numel() and x3.stride(2) != 1:
        raise ValueError("x needs a unit column stride")
    if wp.dtype != torch.uint8 or not wp.is_contiguous():
        raise ValueError("wp must be contiguous uint8")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if sx is not None:
        if sx.dtype != torch.float32 or sx.numel() != m \
                or not sx.is_contiguous():
            raise ValueError("sx must be a contiguous fp32 [M, 1] tensor")
    ws_es = 0
    if scales is not None:
        s2 = scales if scales.dim() == 2 else scales[None]
        if scales.dtype != torch.float32 or s2.shape[0] != e \
                or s2.shape[1] * group_size < kp or s2.stride(1) != 1:
            raise ValueError("scales must be fp32 [(E,) Kp // group] with a "
                             "unit group stride")
        ws_es = s2.stride(0)
    if e == 0 or m == 0 or n == 0:
        return out
    lib = _build.library(SOURCE, _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.soniq_segment_gemm(
            x3.data_ptr(), x3.stride(1), x3.stride(0),
            int(x.dtype == torch.bfloat16),
            None if sx is None else sx.data_ptr(), wp3.data_ptr(),
            wp3.stride(0), None if scales is None else scales.data_ptr(),
            ws_es, out3.data_ptr(), out3.stride(0), e, m, n, kp, p,
            group_size, mode, stream)
    _build.check(code, "soniq_segment_gemm")
    LAUNCHES[key] += 1
    return out


def _on_device(x) -> bool:
    """True on a CUDA tensor (launch the kernel), False on a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


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
    if x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} must be 2-D")
    out = _prepare(x, wp, scales, out, p)
    if not _on_device(x):
        return out.add_(fused_act_segment_matmul_plain(
            x, sx, wp, scales, p=p, group_size=group_size))
    return _launch(x, sx, wp, scales, out, p=p, group_size=group_size,
                   mode=FUSED, key="fused_act_segment_matmul")


def fused_act_selfscale_matmul(x: torch.Tensor, wp: torch.Tensor,
                               scales: Optional[torch.Tensor] = None, *,
                               p: int, group_size: int = GROUP_SIZE,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """B2: B1 with the per-token scale ``max(max|x_row|, 1e-6) / 1.875``
    computed in the kernel over the full row (one segment spans K)."""
    if x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} must be 2-D")
    out = _prepare(x, wp, scales, out, p)
    if not _on_device(x):
        return out.add_(fused_act_selfscale_matmul_plain(
            x, wp, scales, p=p, group_size=group_size))
    return _launch(x, None, wp, scales, out, p=p, group_size=group_size,
                   mode=SELF, key="fused_act_selfscale_matmul")


def packed_segment_matmul(x: torch.Tensor, wp: torch.Tensor,
                          scales: Optional[torch.Tensor] = None, *, p: int,
                          act_quant: bool = False,
                          group_size: int = GROUP_SIZE,
                          out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """B3: ``out += x @ unpack_dequant(wp)`` for x [M, Kp] (fp32 or bf16,
    a column slice allowed), snapped to the p-bit grid first when
    ``act_quant``; ``out`` is a fresh zero [M, N] fp32 tensor when not
    given."""
    if x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} must be 2-D")
    out = _prepare(x, wp, scales, out, p)
    if not _on_device(x):
        return out.add_(segment_matmul_plain(
            x, wp, scales, p=p, act_quant=act_quant, group_size=group_size))
    return _launch(x, None, wp, scales, out, p=p, group_size=group_size,
                   mode=SNAP if act_quant else PLAIN,
                   key="packed_segment_matmul")


def packed_segment_matmul_grouped(x: torch.Tensor, wp: torch.Tensor,
                                  scales: Optional[torch.Tensor] = None, *,
                                  p: int, act_quant: bool = False,
                                  group_size: int = GROUP_SIZE,
                                  out: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """B6: B3 per expert in one launch, ``out[e] += x[e] @
    unpack_dequant(wp[e])`` with x [E, M, Kp] (a column slice allowed),
    wp [E, Kp*p//8, N] contiguous and scales [E, Kp // group_size] (a
    column slice of the per-expert scales allowed) or None; ``out`` is a
    fresh zero [E, M, N] fp32 tensor when not given."""
    if x.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} must be [E, M, Kp]")
    out = _prepare(x, wp, scales, out, p)
    if not _on_device(x):
        return out.add_(grouped_matmul_plain(
            x, wp, scales, p=p, act_quant=act_quant, group_size=group_size))
    return _launch(x, None, wp, scales, out, p=p, group_size=group_size,
                   mode=SNAP if act_quant else PLAIN,
                   key="packed_segment_matmul_grouped")
