"""SMOL quantize + bit-pack (B7) and its plain versions.

Counterpart of ``repro.kernels.quant_pack``: w [K, N] fp32, optionally
divided by per-group scales, -> SMOL codes packed 8/p per byte along K,
little-endian -> uint8 [K*p//8, N]. Bit-exact with the reference.

``quantize_pack_segments`` packs a whole linear, or an [S, K, N] stack of
slices (an expert bank), into its [K4|K2|K1] segments in one launch,
reading the rows through the channel permutation in place; ``quantize_pack``
is its one-segment, identity-permutation case (the TPU kernel). On CUDA
tensors the wrappers launch ``csrc/quant_pack.cu`` or raise; on CPU
tensors they run the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import pack, quant
from repro_torch.core.qtypes import GROUP_SIZE

from . import _build

SOURCE = "quant_pack.cu"
PRECISIONS = (4, 2, 1)          # segment order of the carriers

# Launches of the CUDA kernel in this process (plain-version calls do not
# count); reset by whoever reads it.
LAUNCHES: Dict[str, int] = {"quantize_pack": 0}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.soniq_quant_pack_segments
    fn.argtypes = [ptr, ctypes.c_longlong, i32, ptr, ptr, ptr, ptr, ptr,
                   i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32


def quantize_pack_plain(w: torch.Tensor, scales: Optional[torch.Tensor] = None,
                        *, p: int, group_size: int = GROUP_SIZE
                        ) -> torch.Tensor:
    """Plain version: divide by the group scales, round to codes, pack."""
    k = w.shape[0]
    ws = w.float()
    if scales is not None:
        ws = ws / quant.expand_groups(scales.float(), k, group_size)[:, None]
    return pack.pack_codes(quant.quantize_to_int(ws, p), p)


def quantize_pack_segments_plain(w: torch.Tensor,
                                 perm: Optional[torch.Tensor] = None,
                                 scales: Optional[torch.Tensor] = None, *,
                                 segments: Sequence[int],
                                 group_size: int = GROUP_SIZE
                                 ) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`quantize_pack_segments`: gather the rows by
    ``perm``, then ``quantize_pack_plain`` per segment and per slice."""
    stacked = w.dim() == 3
    w3 = w if stacked else w[None]
    perm3 = None if perm is None else (perm if stacked else perm[None])
    sc3 = None if scales is None else (scales if stacked else scales[None])
    outs = []
    for i in range(w3.shape[0]):
        ws = w3[i] if perm3 is None else w3[i].index_select(0, perm3[i])
        segs, off = [], 0
        for p, kp in zip(PRECISIONS, segments):
            if kp == 0:
                segs.append(torch.zeros((0, ws.shape[1]), dtype=torch.uint8,
                                        device=ws.device))
                continue
            goff, ng = off // group_size, max(kp // group_size, 1)
            segs.append(quantize_pack_plain(
                ws[off:off + kp],
                None if sc3 is None else sc3[i, goff:goff + ng], p=p,
                group_size=group_size))
            off += kp
        outs.append(segs)
    if not stacked:
        return tuple(outs[0])
    return tuple(torch.stack([o[j] for o in outs]) for j in range(3))


def _check(w, perm, scales, segments, group_size):
    """One pass over the operands; returns (S, K, N)."""
    if w.dim() not in (2, 3):
        raise ValueError(f"w must be [K, N] or [S, K, N], got "
                         f"{tuple(w.shape)}")
    *lead, k, n = w.shape
    if len(segments) != 3 or sum(segments) != k or any(
            kp < 0 or kp % (8 // p) for p, kp in zip(PRECISIONS, segments)):
        raise ValueError(f"segments {tuple(segments)} do not pack K={k}")
    ng = -(-k // group_size)
    for t, name, dt, last in ((perm, "perm", torch.int32, k),
                              (scales, "scales", torch.float32, ng)):
        if t is not None and (t.shape != tuple(lead) + (last,)
                              or t.dtype != dt or t.device != w.device):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be "
                             f"{dt} {tuple(lead) + (last,)} on {w.device}")
    return (lead[0] if lead else 1), k, n


def quantize_pack_segments(w: torch.Tensor,
                           perm: Optional[torch.Tensor] = None,
                           scales: Optional[torch.Tensor] = None, *,
                           segments: Sequence[int],
                           group_size: int = GROUP_SIZE,
                           out: Optional[Sequence[torch.Tensor]] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """B7 over a whole linear: w [K, N] (or [S, K, N]) fp32 -> the
    carriers (w4, w2, w1) uint8 [Kp * p // 8, N] (or [S, ...]) of the
    ``segments`` (K4, K2, K1). Sorted row k of slice s is w's row
    ``perm[s, k]`` (int32 [S, K]; None: row k), divided by
    ``scales[s, k // group_size]`` (fp32 [S, K // G], in sorted order;
    None: no division). ``out``: the three contiguous carriers to write
    (else allocated here)."""
    s, k, n = _check(w, perm, scales, segments, group_size)
    lead = tuple(w.shape[:-2])
    shapes = [lead + (kp * p // 8, n) for p, kp in zip(PRECISIONS, segments)]
    if out is not None and (len(out) != 3 or any(
            o.shape != shape or o.dtype != torch.uint8
            or o.device != w.device or not o.is_contiguous()
            for o, shape in zip(out, shapes))):
        raise ValueError(f"out must be contiguous uint8 {shapes} on "
                         f"{w.device}")
    if w.device.type == "cpu":
        got = quantize_pack_segments_plain(
            w, perm, scales, segments=segments, group_size=group_size)
        return got if out is None else tuple(o.copy_(g)
                                             for o, g in zip(out, got))
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    if w.dtype != torch.float32 or w.stride(-1) != 1:
        raise ValueError("w must be fp32 with contiguous rows")
    for t in (perm, scales):
        if t is not None and not t.is_contiguous():
            raise ValueError("perm and scales must be contiguous")
    outs = tuple(out) if out is not None else tuple(
        torch.empty(shape, dtype=torch.uint8, device=w.device)
        for shape in shapes)
    if w.numel() == 0:
        return outs
    lib = _build.library(SOURCE, _bind)
    code = _build.launch(
        w.device, lib.soniq_quant_pack_segments, w.data_ptr(),
        w.stride(0) if lead else 0, w.stride(-2) if k > 1 else n,
        None if perm is None else perm.data_ptr(),
        None if scales is None else scales.data_ptr(),
        *(o.data_ptr() if o.numel() else None for o in outs), *segments, n,
        s, group_size)
    _build.check(code, "soniq_quant_pack_segments")
    LAUNCHES["quantize_pack"] += 1
    return outs


def quantize_pack(w: torch.Tensor, scales: Optional[torch.Tensor] = None, *,
                  p: int, group_size: int = GROUP_SIZE) -> torch.Tensor:
    """w [K, N] fp32 -> uint8 [K*p//8, N] SMOL codes (packed along K): the
    one-segment, identity-permutation case of
    :func:`quantize_pack_segments`."""
    if w.dim() != 2:
        raise ValueError(f"w must be 2-D, got {tuple(w.shape)}")
    k = w.shape[0]
    if p not in PRECISIONS or k % (8 // p):
        raise ValueError(f"K={k} does not pack at p={p}")
    if scales is not None:
        ng = -(-k // group_size)
        if scales.numel() < ng:
            raise ValueError(f"scales must hold K // group = {ng} values")
        scales = scales.reshape(-1)[:ng]
    segments = tuple(k if q == p else 0 for q in PRECISIONS)
    return quantize_pack_segments(w, None, scales, segments=segments,
                                  group_size=group_size)[
        PRECISIONS.index(p)]
