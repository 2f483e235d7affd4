"""Segment GEMMs (B1, B2, B3, B6) and their plain versions.

Counterpart of ``repro.kernels.packed_matmul``: x [M, Kp] @
unpack_dequant(wp [Kp*p//8, N]) * wscale, accumulated in fp32 into
``out`` [M, N], for one uniform-precision segment or, in one launch, for
up to three segments of a leaf in [K4|K2|K1] order (``segments_matmul``).
The fused forms quantize the activations in the prologue,

    xq = round_through_x_dtype(snap_p(x / sx) * sx),

with the per-token scale ``sx`` from the driver (B1,
``fused_act_segment_matmul``) or computed over the full row (B2, the
self-scale form, legal when one segment spans K). The plain form (B3,
``packed_segment_matmul``) takes x as it is, or snapped to the grid when
``act_quant`` (x already in scale units): the second pass of the two-pass
form. The grouped form (B6, ``packed_segment_matmul_grouped``) is B3 over
a stacked expert bank, x [E, M, Kp] @ wp [E, Kp*p//8, N] -> [E, M, N],
optionally with ``rows`` [E]: each expert's live rows (0..rows[e]-1),
the others left as they were. All of them are one CUDA kernel body with a
mode, so they share one order of accumulation, and a launch over three
segments equals three single-segment launches bitwise.

On CUDA tensors the wrappers launch ``csrc/segment_gemm.cu`` or raise; on
CPU tensors they run the plain versions below, which repeat the element
ops in torch and sum by the port's row-reduction rule (``core.numerics``:
float64, one rounding), so the CUDA kernel's fp32 sum is held against a
reference within rounding of the exact one.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import pack, quant
from repro_torch.core.numerics import sum_fp64
from repro_torch.core.qtypes import GROUP_SIZE

from . import _build

SOURCE = "segment_gemm.cu"

# Launches of each CUDA kernel in this process (plain-version calls do not
# count); reset by whoever reads them. A launch over several segments
# counts once, under its mode's key.
LAUNCHES: Dict[str, int] = {"fused_act_segment_matmul": 0,
                            "fused_act_selfscale_matmul": 0,
                            "packed_segment_matmul": 0,
                            "packed_segment_matmul_grouped": 0}

# Prologue modes of the kernel (csrc/segment_gemm.cu).
FUSED, SELF, PLAIN, SNAP = 0, 1, 2, 3

# One segment of a launch: carriers [(E,) Kp*p//8, N], group scales
# [(E,) Kp // group] or None, the precision p, and the segment's first
# channel in x.
Segment = Tuple[torch.Tensor, Optional[torch.Tensor], int, int]

MAX_SEGMENTS = 3


class _SegmentArg(ctypes.Structure):
    """One segment of a launch (``SegmentArg`` in csrc/segment_gemm.cu)."""
    _fields_ = [("wp", ctypes.c_void_p), ("wp_es", ctypes.c_longlong),
                ("ws", ctypes.c_void_p), ("ws_es", ctypes.c_longlong),
                ("p", ctypes.c_int), ("k_off", ctypes.c_int),
                ("kp", ctypes.c_int), ("pad", ctypes.c_int)]


class _SegmentArgs(ctypes.Structure):
    """A launch's segments, passed to the kernel entry by value."""
    _fields_ = [("s", _SegmentArg * MAX_SEGMENTS)]


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.soniq_segment_gemm
    ll, i, vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [vp, ll, ll, i, vp, i, _SegmentArgs, vp, ll, vp,
                   i, i, i, i, i, vp]
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
                         group_size: int = GROUP_SIZE,
                         rows: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of B6: B3's plain version per expert, x [E, M, Kp],
    wp [E, Kp*p//8, N], scales [E, Kp // group_size] or None ->
    fp32 [E, M, N]. With ``rows`` [E], only rows 0..rows[e]-1 of expert e
    are computed; the others are zero, so a caller that adds the result
    leaves them as they were."""
    e, m = x.shape[:2]
    live = [m] * e if rows is None else [min(int(r), m)
                                         for r in rows.tolist()]
    out = torch.zeros((e, m, wp.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for i in range(e):
        if live[i] > 0:
            out[i, :live[i]] = segment_matmul_plain(
                x[i, :live[i]], wp[i], None if scales is None else scales[i],
                p=p, act_quant=act_quant, group_size=group_size)
    return out


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
def _mode(sx, self_scale: bool, act_quant: bool) -> int:
    if self_scale:
        if sx is not None:
            raise ValueError("the self-scale form computes its own scale")
        return SELF
    if sx is not None:
        return FUSED
    return SNAP if act_quant else PLAIN


def _key(mode: int, grouped: bool) -> str:
    if mode == FUSED:
        return "fused_act_segment_matmul"
    if mode == SELF:
        return "fused_act_selfscale_matmul"
    return ("packed_segment_matmul_grouped" if grouped
            else "packed_segment_matmul")


def _kp(wp: torch.Tensor, p: int) -> int:
    if p not in (1, 2, 4):
        raise ValueError(f"p={p} not in (1, 2, 4)")
    return wp.shape[-2] * (8 // p)


def _check(x, segments, sx, rows, mode, out):
    """Shapes of a launch: ``x`` [(E,) M, K] against each segment's
    carriers [(E,) Kp*p//8, N]; returns ``out`` (a fresh zero fp32
    [(E,) M, N] when not given)."""
    grouped = x.dim() == 3
    if x.dim() not in (2, 3):
        raise ValueError(f"x {tuple(x.shape)} must be 2-D (one leaf) or "
                         "3-D (experts)")
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"{len(segments)} segments; a launch takes 1 to "
                         f"{MAX_SEGMENTS}")
    if mode == SELF and len(segments) != 1:
        raise ValueError("the self-scale form takes one segment spanning K")
    if grouped and mode in (FUSED, SELF):
        raise ValueError("the grouped form takes the plain or snap mode")
    if rows is not None and not grouped:
        raise ValueError("rows applies to the grouped form only")
    n = None
    for wp, _sc, p, off in segments:
        kp = _kp(wp, p)
        if wp.dim() != x.dim():
            raise ValueError(f"x {tuple(x.shape)} and wp {tuple(wp.shape)} "
                             "must both be 2-D or both 3-D")
        if grouped and wp.shape[0] != x.shape[0]:
            raise ValueError(f"x has {x.shape[0]} experts, wp {wp.shape[0]}")
        if off < 0 or off + kp > x.shape[-1]:
            raise ValueError(f"segment [{off}, {off + kp}) outside x's "
                             f"{x.shape[-1]} channels")
        if n is not None and wp.shape[-1] != n:
            raise ValueError("segments of one launch share N")
        n = wp.shape[-1]
    shape = tuple(x.shape[:-1]) + (n,)
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=x.device)
    elif tuple(out.shape) != shape or out.dtype != torch.float32:
        raise ValueError(f"out must be fp32 {list(shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    return out


def segments_matmul_plain(x: torch.Tensor, segments: Sequence[Segment], *,
                          sx: Optional[torch.Tensor] = None,
                          self_scale: bool = False, act_quant: bool = False,
                          rows: Optional[torch.Tensor] = None,
                          group_size: int = GROUP_SIZE,
                          out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version of :func:`segments_matmul`: each segment's plain
    version added into ``out`` (a fresh zero fp32 tensor when not given)
    one after the other, as the kernel adds each segment's sum."""
    mode = _mode(sx, self_scale, act_quant)
    out = _check(x, segments, sx, rows, mode, out)
    for wp, sc, p, off in segments:
        xs = x[..., off:off + _kp(wp, p)]
        if x.dim() == 3:
            part = grouped_matmul_plain(xs, wp, sc, p=p,
                                        act_quant=mode == SNAP,
                                        group_size=group_size, rows=rows)
        elif mode == FUSED:
            part = fused_act_segment_matmul_plain(xs, sx, wp, sc, p=p,
                                                  group_size=group_size)
        elif mode == SELF:
            part = fused_act_selfscale_matmul_plain(xs, wp, sc, p=p,
                                                    group_size=group_size)
        else:
            part = segment_matmul_plain(xs, wp, sc, p=p,
                                        act_quant=mode == SNAP,
                                        group_size=group_size)
        out.add_(part)
    return out


def _launch(x, segments, sx, rows, mode, group_size, out):
    """One launch over the segments and E experts (a 2-D x is one
    expert)."""
    dev = x.device
    for name, t in (("sx", sx), ("rows", rows), ("out", out)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be fp32 or bf16, got {x.dtype}")
    grouped = x.dim() == 3
    e, m = (x.shape[0], x.shape[1]) if grouped else (1, x.shape[0])
    n = out.shape[-1]
    if x.numel() and x.stride(-1) != 1:
        raise ValueError("x needs a unit column stride")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if sx is not None and (sx.dtype != torch.float32 or sx.numel() != m
                           or not sx.is_contiguous()):
        raise ValueError("sx must be a contiguous fp32 [M, 1] tensor")
    if rows is not None and (rows.dtype != torch.int32
                             or tuple(rows.shape) != (e,)
                             or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous int32 [{e}] tensor")
    table = _SegmentArgs()
    for slot, (wp, sc, p, off) in zip(table.s, segments):
        if wp.device != dev or (sc is not None and sc.device != dev):
            raise ValueError(f"a segment is off x's device {dev}")
        if wp.dtype != torch.uint8 or not wp.is_contiguous():
            raise ValueError("wp must be contiguous uint8")
        kp = _kp(wp, p)
        es = 0
        if sc is not None:
            ng = sc.shape[-1]
            if sc.dtype != torch.float32 or sc.stride(-1) != 1 \
                    or ng * group_size < kp \
                    or (grouped and (sc.dim() != 2 or sc.shape[0] != e)):
                raise ValueError("scales must be fp32 [(E,) Kp // group] "
                                 "with a unit group stride")
            es = sc.stride(0) if grouped else 0
        slot.wp, slot.wp_es = wp.data_ptr(), wp.stride(0) if grouped else 0
        slot.ws = None if sc is None else sc.data_ptr()
        slot.ws_es, slot.p, slot.k_off, slot.kp = es, p, off, kp
    if e == 0 or m == 0 or n == 0:
        return out
    lib = _build.library(SOURCE, _bind)
    args = (x.data_ptr(), x.stride(-2), x.stride(0) if grouped else 0,
            int(x.dtype == torch.bfloat16),
            None if sx is None else sx.data_ptr(), len(segments), table,
            out.data_ptr(), out.stride(0) if grouped else 0,
            None if rows is None else rows.data_ptr(), e, m, n, group_size,
            mode)
    _build.check(_build.launch(dev, lib.soniq_segment_gemm, *args),
                 "soniq_segment_gemm")
    LAUNCHES[_key(mode, grouped)] += 1
    return out


def _on_device(x) -> bool:
    """True on a CUDA tensor (launch the kernel), False on a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def segments_matmul(x: torch.Tensor, segments: Sequence[Segment], *,
                    sx: Optional[torch.Tensor] = None,
                    self_scale: bool = False, act_quant: bool = False,
                    rows: Optional[torch.Tensor] = None,
                    group_size: int = GROUP_SIZE,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch over a leaf's non-empty segments ``[(wp, scales, p,
    k_off)]`` (1 to 3, in [K4|K2|K1] order): ``out += sum_s xq[...,
    k_off_s:k_off_s + Kp_s] @ unpack_dequant(wp_s)``, each segment's sum
    added into ``out`` in turn, so the result is bitwise that of one
    per-segment launch after the other. The mode follows the arguments:
    ``sx`` [M, 1] is B1's driver scale, ``self_scale`` B2 (one segment
    spanning K), otherwise B3 (B6 for x [E, M, K] and carriers [E, ...],
    with ``rows`` [E] int32 the live rows of each expert), snapped to the
    grid first when ``act_quant``. ``out`` is a fresh zero fp32 [(E,) M, N]
    tensor when not given."""
    mode = _mode(sx, self_scale, act_quant)
    out = _check(x, segments, sx, rows, mode, out)
    if not _on_device(x):
        return segments_matmul_plain(x, segments, sx=sx,
                                     self_scale=self_scale,
                                     act_quant=act_quant, rows=rows,
                                     group_size=group_size, out=out)
    return _launch(x, segments, sx, rows, mode, group_size, out)


def _one_segment(x, wp, p, dims):
    if x.dim() != dims:
        raise ValueError(f"x {tuple(x.shape)} must be "
                         f"{'2-D' if dims == 2 else '[E, M, Kp]'}")
    if wp.dim() == dims and _kp(wp, p) != x.shape[-1]:
        raise ValueError(f"wp {tuple(wp.shape)} does not carry "
                         f"{x.shape[-1]} channels at p={p}")


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
    _one_segment(x, wp, p, 2)
    return segments_matmul(x, [(wp, scales, p, 0)], sx=sx,
                           group_size=group_size, out=out)


def fused_act_selfscale_matmul(x: torch.Tensor, wp: torch.Tensor,
                               scales: Optional[torch.Tensor] = None, *,
                               p: int, group_size: int = GROUP_SIZE,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """B2: B1 with the per-token scale ``max(max|x_row|, 1e-6) / 1.875``
    computed in the kernel over the full row (one segment spans K)."""
    _one_segment(x, wp, p, 2)
    return segments_matmul(x, [(wp, scales, p, 0)], self_scale=True,
                           group_size=group_size, out=out)


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
    _one_segment(x, wp, p, 2)
    return segments_matmul(x, [(wp, scales, p, 0)], act_quant=act_quant,
                           group_size=group_size, out=out)


def packed_segment_matmul_grouped(x: torch.Tensor, wp: torch.Tensor,
                                  scales: Optional[torch.Tensor] = None, *,
                                  p: int, act_quant: bool = False,
                                  group_size: int = GROUP_SIZE,
                                  out: Optional[torch.Tensor] = None,
                                  rows: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """B6: B3 per expert in one launch, ``out[e] += x[e] @
    unpack_dequant(wp[e])`` with x [E, M, Kp] (a column slice allowed),
    wp [E, Kp*p//8, N] contiguous and scales [E, Kp // group_size] (a
    column slice of the per-expert scales allowed) or None; ``out`` is a
    fresh zero [E, M, N] fp32 tensor when not given. ``rows`` [E] int32:
    only rows 0..rows[e]-1 of expert e are read and written."""
    _one_segment(x, wp, p, 3)
    return segments_matmul(x, [(wp, scales, p, 0)], act_quant=act_quant,
                           rows=rows, group_size=group_size, out=out)
