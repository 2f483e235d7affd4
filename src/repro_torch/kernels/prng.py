"""Counter-based PRNG of the Phase-I noise kernel (plain version).

Counterpart of ``repro.kernels.prng``: an xxhash-style avalanche of
(global element index, seed) -> uint32, and U[-1, 1) from its top 24 bits.
The same hash runs as a ``__device__`` function in ``csrc/noise_inject.cu``.
Eager torch has no uint32 multiply, so the plain version works in int64
masked to 32 bits, and splits each multiply into 16-bit halves so that no
product leaves the int64 range: every value equals the reference's uint32
arithmetic bit for bit.
"""
from __future__ import annotations

from typing import Union

import torch

MASK = 0xFFFFFFFF
C1, C2, C3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32): the high half's product
    only contributes its low 16 bits, so both partial products stay
    below 2^49."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def hash_u32(idx: torch.Tensor, seed: Union[int, torch.Tensor]
             ) -> torch.Tensor:
    """Avalanche hash of uint32 ``idx`` and ``seed`` (int64 values in
    [0, 2^32)) -> int64 values in [0, 2^32)."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=idx.device)
    h = (_mul_u32(idx.long() & MASK, C1) + (seed & MASK)) & MASK
    h = h ^ (h >> 15)
    h = _mul_u32(h, C2)
    h = h ^ (h >> 13)
    h = _mul_u32(h, C3)
    return h ^ (h >> 16)


def uniform_pm1(idx: torch.Tensor, seed: Union[int, torch.Tensor]
                ) -> torch.Tensor:
    """Deterministic U[-1, 1) from (index, seed), fp32: the top 24 bits
    times 2^-23, minus 1 (both steps exact in fp32)."""
    bits = hash_u32(idx, seed) >> 8
    return bits.float() * (2.0 / (1 << 24)) - 1.0


def element_index(k: int, n: int, device, row0: int = 0) -> torch.Tensor:
    """The global index ``k_i * n + n_j`` of every element of a [k, n]
    array, int64 (the reference's uint32 index; k * n < 2^32); with
    ``row0``, of rows row0 .. row0 + k - 1 of a taller array."""
    if (row0 + k) * n >= 1 << 32:
        raise ValueError(f"[{row0 + k}, {n}] has more elements than a "
                         f"uint32 index")
    rows = torch.arange(row0, row0 + k, dtype=torch.int64,
                        device=device)[:, None] * n
    return rows + torch.arange(n, dtype=torch.int64, device=device)[None, :]
