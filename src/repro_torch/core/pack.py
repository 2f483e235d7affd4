"""Bit-packing of SMOL codes into uint8 carriers. Counterpart of
``repro.core.pack``.

A p-bit code stream along K packs little-endian into bytes: code ``j`` of
a byte sits at bit ``p*j``, 8/p codes per byte. A weight [K, N] packs to
[K*p//8, N]. Mixed precision uses the segment layout [K4 | K2 | K1]: three
carriers ``w4``/``w2``/``w1``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch

from . import quant

# The canonical [K4 | K2 | K1] segment order: (carrier name, precision
# bits, codes per carrier byte).
SEGMENTS: Tuple[Tuple[str, int, int], ...] = (("w4", 4, 2), ("w2", 2, 4),
                                              ("w1", 1, 8))


def iter_packed_segments(bufs: Dict, group_size: int = 16
                         ) -> Iterator[Tuple[str, int, int, int, int, int]]:
    """Yield ``(name, p, k_off, kp, g_off, ng)`` for each non-empty
    segment of carriers ``{"w4": ..., "w2": ..., "w1": ...}`` in
    [K4|K2|K1] order: the carrier, its precision, the channel offset and
    length along K, and the group offset and count."""
    k_off = g_off = 0
    for name, p, vals_per_byte in SEGMENTS:
        kp = bufs[name].shape[0] * vals_per_byte
        if kp == 0:
            continue
        ng = max(kp // group_size, 1)
        yield name, p, k_off, kp, g_off, ng
        k_off += kp
        g_off += ng


def pack_codes(u: torch.Tensor, p: int) -> torch.Tensor:
    """Pack unsigned p-bit codes along dim 0: [K, ...] -> [K*p//8, ...]."""
    if p not in (1, 2, 4):
        raise ValueError(f"p={p} not in (1, 2, 4)")
    vpb = 8 // p
    k = u.shape[0]
    if k % vpb:
        raise ValueError(f"K={k} not a multiple of {vpb} codes per byte")
    u = u.to(torch.uint8).reshape((k // vpb, vpb) + tuple(u.shape[1:]))
    out = torch.zeros(u.shape[:1] + u.shape[2:], dtype=torch.uint8,
                      device=u.device)
    for j in range(vpb):
        out |= u[:, j] << (p * j)
    return out


def unpack_codes(b: torch.Tensor, p: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: [K*p//8, ...] -> [K, ...] uint8."""
    if p not in (1, 2, 4):
        raise ValueError(f"p={p} not in (1, 2, 4)")
    vpb = 8 // p
    b = b.to(torch.uint8)
    parts = [(b >> (p * j)) & ((1 << p) - 1) for j in range(vpb)]
    return torch.stack(parts, dim=1).reshape((k,) + tuple(b.shape[1:]))


def dequant_codes(u: torch.Tensor, p: int) -> torch.Tensor:
    """Codes -> fp32 grid values ``(2u - (2^p - 1)) * 2^(1-p)``."""
    return (2.0 * u.float() - float(2 ** p - 1)) * float(2.0 ** (1 - p))


def dequant_packed_carriers(bufs: Dict, wscale: Optional[torch.Tensor] = None,
                            group_size: int = 16) -> torch.Tensor:
    """Packed carriers -> dequantized fp32 [K, N] weight, with the
    optional per-group ``wscale`` applied."""
    parts = [dequant_codes(unpack_codes(bufs[name], p, kp), p)
             for name, p, _o, kp, _go, _ng
             in iter_packed_segments(bufs, group_size)]
    wd = torch.cat(parts, dim=0)
    if wscale is not None:
        wd = wd * quant.expand_groups(wscale.float(), wd.shape[0],
                                      group_size)[:, None]
    return wd
