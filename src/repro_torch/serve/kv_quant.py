"""Packed 4-bit KV cache: quantize, ring-write, read, byte accounting and
slot management. Counterpart of ``repro.serve.kv_quant``.

K/V live as SMOL 4-bit codes packed two per byte (channel 2j in the low
nibble) with one fp16 scale per (batch row, slot, kv-head). The scale is
``max(max|x|, ACT_SCALE_EPS) / 1.875`` clamped to the fp16 maximum and
stored as fp16; the codes are computed against the stored scale's fp32
value, so a head above ~1.2e5 saturates to the top of the grid instead of
decoding to inf. Bit-equal with the reference.

Ring writes happen in place: each live lane (pos >= 0) writes slot
``pos % cache_len``; masked lanes (pos < 0: idle slots, prefill padding)
are filtered out before the write, the counterpart of the reference's
out-of-bounds ``mode="drop"`` scatter. ``pos`` is int32, as in the
reference (the fused attention kernels read it as such).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.quant import ACT_SCALE_EPS

P_BITS = 4
GRID_MAX = 2.0 - 2.0 ** (1 - P_BITS)
_SCALE_MAX = float(np.finfo(np.float16).max)   # fp16 scale saturation

# Live-lane write index of a ring: (batch rows, lanes, ring slots).
RingWrite = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (codes uint8 [..., D // 2], scale f16 [..., 1])."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True),
                       min=ACT_SCALE_EPS)
    scale = quant.div_const(amax, GRID_MAX)
    scale = torch.minimum(scale, torch.full((), _SCALE_MAX,
                                            device=scale.device))
    scale = scale.to(torch.float16)
    u = quant.quantize_to_int(xf / scale.float(), P_BITS).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """(codes [..., D // 2], scale [..., 1]) -> [..., D] in ``dtype``."""
    lo = (codes & 0xF).to(dtype)
    hi = ((codes >> 4) & 0xF).to(dtype)
    u = torch.stack([lo, hi], dim=-1).reshape(codes.shape[:-1]
                                              + (codes.shape[-1] * 2,))
    v = (2.0 * u - (2 ** P_BITS - 1)) * (2.0 ** (1 - P_BITS))
    return v * scale.to(dtype)


def init_qkv_cache(batch: int, cache_len: int, num_kv_heads: int,
                   head_dim: int, *, device) -> Dict:
    if head_dim % 2:
        raise ValueError(f"head_dim {head_dim} must be even (two codes per "
                         f"byte)")
    codes = (batch, cache_len, num_kv_heads, head_dim // 2)
    scales = (batch, cache_len, num_kv_heads, 1)
    return {
        "k_codes": torch.zeros(codes, dtype=torch.uint8, device=device),
        "v_codes": torch.zeros(codes, dtype=torch.uint8, device=device),
        "k_scale": torch.zeros(scales, dtype=torch.float16, device=device),
        "v_scale": torch.zeros(scales, dtype=torch.float16, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def host_array(a) -> np.ndarray:
    """A host numpy view of a tensor (copied off the device) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def ring_write_index(pos, ring_len: int, device) -> RingWrite:
    """Host positions [B, S] (or [B]) -> device (batch, lane, ring slot)
    index tensors of the live lanes (pos >= 0). Computed once per step on
    the host and shared by every layer, so the write needs no device
    sync."""
    pos = host_array(pos)
    if pos.ndim == 1:
        pos = pos[:, None]
    bi, si = np.nonzero(pos >= 0)
    slot = pos[bi, si] % ring_len
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (bi, si, slot))


def update_qkv_cache(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                     pos, *, write: Optional[RingWrite] = None) -> Dict:
    """Quantize and ring-write a chunk of new K/V (``k_new``/``v_new``
    [B, S, H, D]) at slot ``pos % cache_len``, in place. ``pos`` is [B] or
    [B, S] absolute positions; lanes with ``pos < 0`` are dropped.
    ``write`` is the precomputed :func:`ring_write_index` of ``pos``."""
    if write is None:
        write = ring_write_index(pos, cache["pos"].shape[1],
                                 cache["pos"].device)
    bi, si, slot = write
    return write_codes(cache, k_new, v_new, pos, (bi, si), (bi, slot))


def write_codes(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor, pos,
                src: Tuple[torch.Tensor, ...],
                dst: Tuple[torch.Tensor, ...]) -> Dict:
    """Quantize the live K/V rows ``k_new[src]`` / ``v_new[src]`` ([B, S]
    lane index) and store their codes, scales and positions at
    ``cache[leaf][dst]`` (a ring slot or a pool page and offset), in
    place."""
    kc, ks = quantize_kv(k_new[src])
    vc, vs = quantize_kv(v_new[src])
    posb = torch.as_tensor(pos, device=cache["pos"].device)
    if posb.dim() == 1:
        posb = posb[:, None]
    for name, val in (("k_codes", kc), ("v_codes", vc), ("k_scale", ks),
                      ("v_scale", vs), ("pos", posb[src])):
        cache[name][dst] = val.to(cache[name].dtype)
    return cache


def read_qkv_cache(cache: Dict, dtype=torch.bfloat16):
    """-> (k [B, T, H, D], v [B, T, H, D], pos [B, T])."""
    k = dequantize_kv(cache["k_codes"], cache["k_scale"], dtype)
    v = dequantize_kv(cache["v_codes"], cache["v_scale"], dtype)
    return k, v, cache["pos"]


# ------------------------------------------------- byte accounting ----
# The "4x cache bytes" claim compares the ring K/V payload only: codes +
# scales for the 4-bit family, k/v buffers for the fp family. ``pos`` and
# the paged layout's ``page_table`` are bookkeeping (the meta bucket), and
# leaves under a ``cross`` subtree are never ring payload.
_KV_PAYLOAD_LEAVES = frozenset({"k", "v", "k_codes", "v_codes",
                                "k_scale", "v_scale"})
_META_LEAVES = frozenset({"pos", "page_table"})


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...],
                                             torch.Tensor]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, path)
    elif tree is not None:
        yield path, tree


def _leaf_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ring_bytes(cache, names) -> int:
    return sum(_leaf_bytes(t) for path, t in _leaves(cache)
               if path[-1] in names and "cross" not in path)


def cache_payload_bytes(cache) -> int:
    """Ring K/V payload bytes of a cache tree (one layer's dict or the
    whole ``lm.init_cache`` tree)."""
    return _ring_bytes(cache, _KV_PAYLOAD_LEAVES)


def cache_meta_bytes(cache) -> int:
    """Bytes of the ``pos`` / ``page_table`` bookkeeping."""
    return _ring_bytes(cache, _META_LEAVES)


def cross_payload_bytes(cache) -> int:
    """Cross-attention K/V payload bytes (0 for decoder-only caches)."""
    return sum(_leaf_bytes(t) for path, t in _leaves(cache)
               if path[-1] in _KV_PAYLOAD_LEAVES and "cross" in path)


def cache_bytes(cache) -> int:
    """Total bytes of every leaf of the cache tree. A tensor shared by
    several layers (the paged layout's page table) counts once per
    layer, as the reference's stacked ``[L, ...]`` leaf does."""
    return sum(_leaf_bytes(t) for _path, t in _leaves(cache))


# ------------------------------------------------- slot management ----
def reset_slots(cache: Dict, slots) -> Dict:
    """Wipe the rows of the given batch slots in place: codes and scales
    zero, ``pos`` -1 (every ring entry of the row reads as empty)."""
    idx = torch.as_tensor(np.asarray(slots, np.int64),
                          device=cache["pos"].device)
    for name, leaf in cache.items():
        leaf[idx] = -1 if name == "pos" else 0
    return cache


def evict_slot(cache: Dict, slot: int) -> Dict:
    """Free one slot's row (request completion/cancellation)."""
    return reset_slots(cache, [slot])


def slot_lengths(cache: Dict) -> torch.Tensor:
    """Number of valid (written, non-evicted) ring entries per slot [B]."""
    return (cache["pos"] >= 0).sum(dim=1).to(torch.int32)
