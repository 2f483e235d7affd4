"""GQA attention. Counterpart of ``repro.models.attention``: the
full-sequence forward of training (``attn_apply``, dense or in query
blocks, fp32 scores and softmax in plain torch, as the reference has no
kernel there) and decode over the layer's KV cache with its cache-family
dispatch:

* fp ring (``k``/``v``/``pos``): plain torch ops (no fused SDPA);
* packed 4-bit ring (``k_codes``...): ``serve/kv_quant.py`` writes, kernel
  B4 attends (``_qkv_attn_decode``);
* packed 4-bit page pool (``page_table``): ``serve/kv_pool.py`` writes,
  kernel B5 attends (``_paged_attn_decode``);
* fp page pool (``page_table`` and ``k``): ``serve/kv_pool.py`` writes,
  the pages gathered into ring order feed the fp ring's plain attention
  (the reference runs a gather oracle here too, no kernel), so its rows
  equal the fp ring's bitwise;

and the encoder-decoder's cross attention over the encoder's K/V
(``cross_attn_decode``: fp through the plain attention, packed 4-bit
through kernel B4), never written by a step.

Caches are updated in place: each live lane (pos >= 0) writes its K/V at
``pos % ring_len`` (or the page the table maps there); masked lanes
(pos < 0: idle slots, prefill padding) are filtered out by index before
the write, the counterpart of the reference's out-of-bounds
``mode="drop"`` scatter. Scores and the value contraction follow the
port's row-reduction rule (``core.numerics``): float64 sums, one rounding.
"""
from __future__ import annotations

import math
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
from .common import apply_rope_tables, rope_tables

CHUNK_THRESHOLD = 2048
Q_BLOCK = 512
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


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                   causal: bool, window: Optional[int]) -> torch.Tensor:
    """Dense path (short sequences): q [B,S,Hk,G,D], k/v [B,T,Hk,D]."""
    mask = causal_mask(q_pos, k_pos, window) if causal else None
    return sdpa(q, k, v, mask)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: Optional[int],
                      q_block: int = Q_BLOCK) -> torch.Tensor:
    """Query blocks of ``q_block`` rows, each with an exact softmax over
    its keys; under a causal sliding window each block sees only the
    [lo, lo + band) key band its window reaches, which makes the work
    O(S * window)."""
    s = q.shape[1]
    t = k.shape[1]
    qb = q_block if s % q_block == 0 else math.gcd(s, q_block)
    banded = causal and window is not None and (window + qb) < t
    band = -(-(window + qb) // qb) * qb if banded else t
    outs = []
    for i in range(s // qb):
        qi, qpi = q[:, i * qb:(i + 1) * qb], q_pos[:, i * qb:(i + 1) * qb]
        lo = min(max(i * qb + qb - band, 0), t - band) if banded else 0
        outs.append(full_attention(
            qi, k[:, lo:lo + band], v[:, lo:lo + band], qpi,
            k_pos[:, lo:lo + band], causal=causal, window=window))
    return torch.cat(outs, dim=1)


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


def attn_apply(attn: Attention, x: torch.Tensor, positions: torch.Tensor, *,
               num_heads: int, num_kv_heads: int, head_dim: int,
               qcfg: QuantConfig, noise: Optional[smol.NoiseSource] = None,
               rope_theta: float = 1e4, mrope_sections=None,
               window: Optional[int] = None,
               causal: bool = True, q_block: int = Q_BLOCK,
               rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               use_rope: bool = True,
               cross_x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (training, prefill, the encoder, cross
    attention). x [B, S, D], positions [B, S], or [3, B, S] for M-RoPE
    (``mrope_sections``: the VLM's temporal, height and width streams);
    ``rope`` the (cos, sin) tables of the positions when the caller
    shares them across layers (``use_rope=False``: none, the
    encoder-decoder's sinusoids are added to the embeddings instead). The
    causal mask and the key positions are the temporal stream's
    (``positions[0]``), as in the reference: the patches of one image
    share it and attend each other both ways. ``causal=False`` attends
    every position (the encoder). With ``cross_x`` [B, T, D] the keys and
    values are its projections at positions 0 .. T - 1, attended without
    a mask. Above ``CHUNK_THRESHOLD`` positions the attention runs in
    query blocks."""
    b, s, _ = x.shape
    xkv = x if cross_x is None else cross_x
    t = xkv.shape[1]
    q = attn.wq(x, qcfg, noise).reshape(b, s, num_heads, head_dim)
    k = attn.wk(xkv, qcfg, noise).reshape(b, t, num_kv_heads, head_dim)
    v = attn.wv(xkv, qcfg, noise).reshape(b, t, num_kv_heads, head_dim)
    pos2d = positions if positions.dim() == 2 else positions[0]
    if cross_x is None:
        if use_rope:
            cos, sin = rope if rope is not None else rope_tables(
                positions, head_dim, rope_theta, mrope_sections)
            q = apply_rope_tables(q, cos, sin)
            k = apply_rope_tables(k, cos, sin)
        k_pos = pos2d
    else:
        k_pos = torch.arange(t, device=x.device)[None].expand(b, t)
        causal = False
    q = q.reshape(b, s, num_kv_heads, num_heads // num_kv_heads, head_dim)
    if s > q_block and s > CHUNK_THRESHOLD:
        o = chunked_attention(q, k, v, pos2d, k_pos, causal=causal,
                              window=window, q_block=q_block)
    else:
        o = full_attention(q, k, v, pos2d, k_pos, causal=causal,
                           window=window)
    return attn.wo(o.reshape(b, s, num_heads * head_dim), qcfg, noise)


def attn_decode(attn: Attention, x: torch.Tensor, cache: Dict,
                pos: torch.Tensor, *, num_heads: int, num_kv_heads: int,
                head_dim: int, qcfg: QuantConfig,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
                write: CacheWrite,
                window: Optional[int] = None) -> torch.Tensor:
    """S-token decode/prefill chunk. x [B, S, D]; pos [B, S] absolute
    positions (< 0 = masked lane); ``rope`` the (cos, sin) tables of pos
    (None: no rotary encoding, the encoder-decoder's); ``write`` the
    live-lane index of pos (:func:`cache_write_index`). Writes the new
    K/V into the cache in place, then attends with the causal-by-position
    (and sliding-window) mask."""
    b, s = x.shape[:2]
    q = attn.wq(x, qcfg).reshape(b, s, num_heads, head_dim)
    k_new = attn.wk(x, qcfg).reshape(b, s, num_kv_heads, head_dim)
    v_new = attn.wv(x, qcfg).reshape(b, s, num_kv_heads, head_dim)
    if rope is not None:
        cos, sin = rope
        q = apply_rope_tables(q, cos, sin)
        k_new = apply_rope_tables(k_new, cos, sin)
    if "page_table" in cache and "k" in cache:      # fp page pool
        kv_pool.update_paged_cache(cache, k_new, v_new, pos, write=write)
        kk, vv, kp = kv_pool.gather_paged(cache, q.dtype)
        return _fp_attn(attn, q, kk, vv, kp, pos, num_heads=num_heads,
                        num_kv_heads=num_kv_heads, head_dim=head_dim,
                        qcfg=qcfg, window=window)
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
    return _fp_attn(attn, q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                    cache["pos"], pos, num_heads=num_heads,
                    num_kv_heads=num_kv_heads, head_dim=head_dim, qcfg=qcfg,
                    window=window)


def _fp_attn(attn: Attention, q, k, v, k_pos, pos, *, num_heads: int,
             num_kv_heads: int, head_dim: int, qcfg: QuantConfig,
             window: Optional[int]) -> torch.Tensor:
    """fp tail of :func:`attn_decode`: q [B, S, H, D] against a ring view
    of the cache (k/v [B, T, Hk, D] in q's dtype, ``k_pos`` [B, T]) under
    the causal-by-position mask, then the output projection."""
    b, s = q.shape[:2]
    qr = q.reshape(b, s, num_kv_heads, num_heads // num_kv_heads, head_dim)
    mask = causal_mask(pos, k_pos, window)
    o = sdpa(qr, k, v, mask)
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


# The query position of cross attention over the packed 4-bit cross K/V:
# above every stored key position (all 0), so B4's causal mask passes
# every entry, as the reference's unbounded query does.
CROSS_QUERY_POS = 2 ** 30


def cross_attn_decode(attn: Attention, x: torch.Tensor, cross_kv: Dict, *,
                      num_heads: int, num_kv_heads: int, head_dim: int,
                      qcfg: QuantConfig) -> torch.Tensor:
    """Cross attention of an S-token chunk x [B, S, D] over one decoder
    layer's encoder K/V (``lm.build_cross_cache``: fp ``k``/``v`` [B, T,
    Hk, D], or the packed 4-bit codes and scales), no mask, no cache
    update. The fp form runs the plain attention of the fp ring; the
    4-bit form kernel B4, with every stored key position read as 0 and
    the query at ``CROSS_QUERY_POS``: every entry attended, unwritten
    ones as zero K/V, as the reference's fp cross. Only q and the output
    are projected: the reference also projects x through the cross
    layer's ``wk`` and ``wv`` at every step and drops the result."""
    b, s = x.shape[:2]
    g = num_heads // num_kv_heads
    q = attn.wq(x, qcfg).reshape(b, s, num_kv_heads, g, head_dim)
    if "k_codes" in cross_kv:
        layer = dict(cross_kv)
        layer["pos"] = torch.zeros_like(cross_kv["pos"])
        qpos = torch.full((b, s), CROSS_QUERY_POS, dtype=torch.int32,
                          device=x.device)
        o = backend.qkv_attn_decode(q, layer, qpos).to(x.dtype)
    else:
        o = sdpa(q, cross_kv["k"].to(q.dtype), cross_kv["v"].to(q.dtype),
                 None)
    return attn.wo(o.reshape(b, s, num_heads * head_dim), qcfg)
