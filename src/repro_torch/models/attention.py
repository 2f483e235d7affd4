"""GQA decode attention over the layer's KV cache. Counterpart of
``repro.models.attention.attn_decode`` and its cache-family dispatch:

* fp ring (``k``/``v``/``pos``): plain torch ops (no fused SDPA);
* packed 4-bit ring (``k_codes``...): ``serve/kv_quant.py`` writes, kernel
  B4 attends (``_qkv_attn_decode``);
* packed 4-bit page pool (``page_table``): ``serve/kv_pool.py`` writes,
  kernel B5 attends (``_paged_attn_decode``).

Caches are updated in place: each live lane (pos >= 0) writes its K/V at
``pos % ring_len`` (or the page the table maps there); masked lanes
(pos < 0: idle slots, prefill padding) are filtered out by index before
the write, the counterpart of the reference's out-of-bounds
``mode="drop"`` scatter. Scores and the value contraction follow the
port's row-reduction rule (``core.numerics``): float64 sums, one rounding.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.backend import base as backend
from repro_torch.core import smol
from repro_torch.core.numerics import sum_fp64
from repro_torch.core.qtypes import QuantConfig
from repro_torch.serve import kv_pool, kv_quant
from repro_torch.serve.kv_quant import RingWrite, ring_write_index
from .common import apply_rope_tables

NEG_INF = -1e30

# The live-lane write index of one step, shared by every layer: a ring's
# (batch, lane, slot) or a page pool's (batch, lane, page, offset).
CacheWrite = Union[RingWrite, kv_pool.PagedWrite]


def attn_init(d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, qcfg: QuantConfig, *, generator, device,
              use_bias: bool = False, dtype=torch.float32) -> Dict:
    kw = dict(generator=generator, device=device, use_bias=use_bias,
              dtype=dtype)
    return {
        "wq": smol.linear_init(d_model, num_heads * head_dim, qcfg, **kw),
        "wk": smol.linear_init(d_model, num_kv_heads * head_dim, qcfg, **kw),
        "wv": smol.linear_init(d_model, num_kv_heads * head_dim, qcfg, **kw),
        "wo": smol.linear_init(num_heads * head_dim, d_model, qcfg, **kw),
    }


def init_kv_cache(batch: int, cache_len: int, num_kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, *,
                  device) -> Dict:
    return {
        "k": torch.zeros((batch, cache_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, num_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int64,
                          device=device),
    }


def cache_write_index(cache: Dict, pos: np.ndarray, device) -> CacheWrite:
    """The live-lane write index of host positions ``pos`` [B, S] for a
    layer cache of any family; one host computation per step (the paged
    form reads the page table once)."""
    if "page_table" in cache:
        return kv_pool.paged_write_index(pos, cache["page_table"],
                                         cache["pos"].shape[1], device)
    return ring_write_index(pos, cache["pos"].shape[1], device)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """[B, Sq], [B, T] -> bool [B, Sq, T] (True = attend)."""
    m = q_pos[:, :, None] >= k_pos[:, None, :]
    if window is not None:
        m &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    m &= k_pos[:, None, :] >= 0
    return m


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B,S,Hk,G,D], k/v [B,T,Hk,D], mask [B,S,T] -> [B,S,Hk,G,D] in
    v's dtype. fp32 scores and softmax."""
    dh = q.shape[-1]
    scores = sum_fp64("bqhgd,bkhd->bhgqk", q, k)
    scores = scores * np.float32(1.0 / np.sqrt(dh))
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full((), NEG_INF, dtype=scores.dtype,
                                        device=scores.device))
    p = torch.softmax(scores.double(), dim=-1).float()
    return sum_fp64("bhgqk,bkhd->bqhgd", p.to(v.dtype), v).to(v.dtype)


class Attention(nn.Module):
    def __init__(self, tree: Dict):
        super().__init__()
        self.wq = smol.SmolLinear(tree["wq"])
        self.wk = smol.SmolLinear(tree["wk"])
        self.wv = smol.SmolLinear(tree["wv"])
        self.wo = smol.SmolLinear(tree["wo"])

    def tree(self) -> Dict:
        return {name: getattr(self, name).leaf()
                for name in ("wq", "wk", "wv", "wo")}


def attn_decode(attn: Attention, x: torch.Tensor, cache: Dict,
                pos: torch.Tensor, *, num_heads: int, num_kv_heads: int,
                head_dim: int, qcfg: QuantConfig,
                rope: Tuple[torch.Tensor, torch.Tensor],
                write: CacheWrite,
                window: Optional[int] = None) -> torch.Tensor:
    """S-token decode/prefill chunk. x [B, S, D]; pos [B, S] absolute
    positions (< 0 = masked lane); ``rope`` the (cos, sin) tables of pos;
    ``write`` the live-lane index of pos (:func:`cache_write_index`).
    Writes the new K/V into the cache in place, then attends with the
    causal-by-position (and sliding-window) mask."""
    b, s = x.shape[:2]
    q = attn.wq(x, qcfg).reshape(b, s, num_heads, head_dim)
    k_new = attn.wk(x, qcfg).reshape(b, s, num_kv_heads, head_dim)
    v_new = attn.wv(x, qcfg).reshape(b, s, num_kv_heads, head_dim)
    cos, sin = rope
    q = apply_rope_tables(q, cos, sin)
    k_new = apply_rope_tables(k_new, cos, sin)
    if "page_table" in cache:              # packed 4-bit page pool
        return _paged_attn_decode(attn, x, cache, pos, k_new, v_new, q,
                                  num_heads=num_heads,
                                  num_kv_heads=num_kv_heads,
                                  head_dim=head_dim, qcfg=qcfg,
                                  write=write, window=window)
    if "k_codes" in cache:                 # packed 4-bit ring
        return _qkv_attn_decode(attn, x, cache, pos, k_new, v_new, q,
                                num_heads=num_heads,
                                num_kv_heads=num_kv_heads,
                                head_dim=head_dim, qcfg=qcfg, write=write,
                                window=window)
    bi, si, slot = write
    cache["k"][bi, slot] = k_new[bi, si].to(cache["k"].dtype)
    cache["v"][bi, slot] = v_new[bi, si].to(cache["v"].dtype)
    cache["pos"][bi, slot] = pos[bi, si]
    g = num_heads // num_kv_heads
    qr = q.reshape(b, s, num_kv_heads, g, head_dim)
    mask = causal_mask(pos, cache["pos"], window)
    o = sdpa(qr, cache["k"].to(qr.dtype), cache["v"].to(qr.dtype), mask)
    return attn.wo(o.reshape(b, s, num_heads * head_dim), qcfg)


def _qkv_attn_decode(attn: Attention, x, cache, pos, k_new, v_new, q, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     qcfg: QuantConfig, write: RingWrite,
                     window: Optional[int]) -> torch.Tensor:
    """Packed 4-bit ring tail of :func:`attn_decode`: quantize and
    ring-write the new K/V (``kv_quant.update_qkv_cache``), then attend
    over the codes through kernel B4."""
    b, s = x.shape[:2]
    kv_quant.update_qkv_cache(cache, k_new, v_new, pos, write=write)
    qr = q.reshape(b, s, num_kv_heads, num_heads // num_kv_heads, head_dim)
    o = backend.qkv_attn_decode(qr, cache, pos, window=window)
    o = o.reshape(b, s, num_heads * head_dim).to(x.dtype)
    return attn.wo(o, qcfg)


def _paged_attn_decode(attn: Attention, x, cache, pos, k_new, v_new, q, *,
                       num_heads: int, num_kv_heads: int, head_dim: int,
                       qcfg: QuantConfig, write: kv_pool.PagedWrite,
                       window: Optional[int]) -> torch.Tensor:
    """Page-pool tail of :func:`attn_decode`: write the new K/V into the
    pages the table maps (the host allocator has made them private), then
    attend by walking the page table through kernel B5."""
    b, s = x.shape[:2]
    kv_pool.update_paged_cache(cache, k_new, v_new, pos, write=write)
    qr = q.reshape(b, s, num_kv_heads, num_heads // num_kv_heads, head_dim)
    o = backend.qkv_attn_decode_paged(qr, cache, pos, window=window)
    o = o.reshape(b, s, num_heads * head_dim).to(x.dtype)
    return attn.wo(o, qcfg)
