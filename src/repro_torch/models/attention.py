"""GQA decode attention over the fp ring KV cache. Counterpart of the
fp-ring branch of ``repro.models.attention.attn_decode``.

Plain torch ops (no fused SDPA). The ring is updated in place: each live
lane (pos >= 0) writes its K/V at ``pos % ring_len``; masked lanes
(pos < 0: idle slots, prefill padding) are filtered out by index before
the write, the counterpart of the reference's out-of-bounds
``mode="drop"`` scatter. Scores and the value contraction follow the
port's row-reduction rule (``core.numerics``): float64 sums, one rounding.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import smol
from repro_torch.core.numerics import sum_fp64
from repro_torch.core.qtypes import QuantConfig
from .common import apply_rope_tables

NEG_INF = -1e30

RingWrite = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def ring_write_index(pos: np.ndarray, ring_len: int,
                     device) -> RingWrite:
    """Host positions [B, S] -> device (batch, lane, ring slot) index
    tensors of the live lanes (pos >= 0). Computed once per step on the
    host, shared by every layer, so the write needs no device sync."""
    pos = np.asarray(pos)
    bi, si = np.nonzero(pos >= 0)
    slot = pos[bi, si] % ring_len
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                 for a in (bi, si, slot))


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
                write: RingWrite,
                window: Optional[int] = None) -> torch.Tensor:
    """S-token decode/prefill chunk. x [B, S, D]; pos [B, S] absolute
    positions (< 0 = masked lane); ``rope`` the (cos, sin) tables of pos;
    ``write`` the live-lane ring index of pos (:func:`ring_write_index`).
    Writes the new K/V into the ring in place, then attends with the
    causal-by-position (and sliding-window) mask."""
    b, s = x.shape[:2]
    q = attn.wq(x, qcfg).reshape(b, s, num_heads, head_dim)
    k_new = attn.wk(x, qcfg).reshape(b, s, num_kv_heads, head_dim)
    v_new = attn.wv(x, qcfg).reshape(b, s, num_kv_heads, head_dim)
    cos, sin = rope
    q = apply_rope_tables(q, cos, sin)
    k_new = apply_rope_tables(k_new, cos, sin)
    bi, si, slot = write
    cache["k"][bi, slot] = k_new[bi, si].to(cache["k"].dtype)
    cache["v"][bi, slot] = v_new[bi, si].to(cache["v"].dtype)
    cache["pos"][bi, slot] = pos[bi, si]
    g = num_heads // num_kv_heads
    qr = q.reshape(b, s, num_kv_heads, g, head_dim)
    mask = causal_mask(pos, cache["pos"], window)
    o = sdpa(qr, cache["k"].to(qr.dtype), cache["v"].to(qr.dtype), mask)
    return attn.wo(o.reshape(b, s, num_heads * head_dim), qcfg)
