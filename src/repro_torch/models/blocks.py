"""Decoder block assembly: the dense ``attn_mlp`` kind and the MoE
``attn_moe`` kind. Counterpart of ``repro.models.blocks``: the
full-sequence forward (``block_apply``) and the decode step over the KV
cache; the other kinds arrive with their families. As in the reference,
every ``attn_mlp`` layer is ``cfg.d_ff`` wide (the reference's plan never
selects ``dense_d_ff``)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.qtypes import QuantConfig
from repro_torch.serve import kv_pool, kv_quant
from . import attention
from . import mlp as mlp_lib
from . import moe as moe_lib
from .common import RMSNorm, rms_norm_init

KINDS = ("attn_mlp", "attn_moe")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} belongs to a later port slice (the port "
            f"serves {KINDS} so far)")


def block_init(kind: str, cfg, qcfg: QuantConfig, *, generator,
               device) -> Dict:
    _check_kind(kind)
    dt = getattr(torch, cfg.param_dtype)
    p = {
        "ln_attn": rms_norm_init(cfg.d_model, device=device),
        "attn": attention.attn_init(
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, qcfg,
            generator=generator, device=device, use_bias=cfg.attn_bias,
            dtype=dt),
        "ln_ffn": rms_norm_init(cfg.d_model, device=device),
    }
    if kind == "attn_moe":
        p["moe"] = moe_lib.moe_init(
            cfg.d_model, cfg.d_ff, cfg.num_experts, qcfg,
            generator=generator, device=device,
            num_shared=cfg.num_shared_experts, act=cfg.mlp_act, dtype=dt)
    else:
        p["mlp"] = mlp_lib.mlp_init(
            cfg.d_model, cfg.d_ff, qcfg, generator=generator, device=device,
            act=cfg.mlp_act, use_bias=cfg.attn_bias, dtype=dt)
    return p


def block_cache_init(kind: str, cfg, batch: int, cache_len: int,
                     dtype=torch.bfloat16, *, device,
                     kv_bits: Optional[int] = None, kv_layout: str = "ring",
                     page_size: int = 16, num_pages: Optional[int] = None,
                     page_table: Optional[torch.Tensor] = None) -> Dict:
    """KV cache of one layer. The ring length is ``cache_len`` clipped to
    the window. ``kv_bits=None`` keeps the fp ring in ``dtype``; 4 the
    packed 4-bit ring (``serve/kv_quant.py``). ``kv_layout="paged"`` (fp or
    4-bit) draws ``page_size``-token pages from a pool of ``num_pages``
    (null page 0 included; None: ``batch * pages_per_seq + 1``) through a
    page table whose length is the ring length in pages, so ``page_size``
    must divide it; ``page_table`` shares one table across layers."""
    _check_kind(kind)
    clen = min(cache_len, cfg.window) if cfg.window else cache_len
    if kv_bits not in (None, 4):
        raise ValueError(f"kv_bits must be None or 4, got {kv_bits}")
    if kv_layout not in ("ring", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r} (expected "
                         f"'ring' or 'paged')")
    if kv_layout == "paged":
        if clen % page_size:
            raise ValueError(
                f"page_size {page_size} must divide the effective ring "
                f"length {clen} (cache_len clipped to the window) so "
                f"paged rollover wraps where the ring does")
        pps = clen // page_size
        npages = num_pages if num_pages is not None else batch * pps + 1
        return {"kv": kv_pool.init_paged_cache(
            npages, page_size, pps, batch, cfg.num_kv_heads, cfg.hd,
            device=device, kv_bits=kv_bits, dtype=dtype, table=page_table)}
    if kv_bits == 4:
        return {"kv": kv_quant.init_qkv_cache(batch, clen, cfg.num_kv_heads,
                                              cfg.hd, device=device)}
    return {"kv": attention.init_kv_cache(batch, clen, cfg.num_kv_heads,
                                          cfg.hd, dtype, device=device)}


class Block(nn.Module):
    def __init__(self, kind: str, tree: Dict, act: str = "swiglu"):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        self.ln_attn = RMSNorm(tree["ln_attn"])
        self.attn = attention.Attention(tree["attn"])
        self.ln_ffn = RMSNorm(tree["ln_ffn"])
        if kind == "attn_moe":
            self.moe = moe_lib.MoE(tree["moe"], act=act)
        else:
            self.mlp = mlp_lib.MLP(tree["mlp"], act=act)

    def tree(self) -> Dict:
        out = {"ln_attn": self.ln_attn.tree(), "attn": self.attn.tree(),
               "ln_ffn": self.ln_ffn.tree()}
        if self.kind == "attn_moe":
            out["moe"] = self.moe.tree()
        else:
            out["mlp"] = self.mlp.tree()
        return out


def _ffn(block: Block, h: torch.Tensor, cfg, qcfg: QuantConfig,
         noise=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's feed-forward and its MoE load-balancing loss (None for
    a dense block and in serving)."""
    if block.kind == "attn_moe":
        return moe_lib.moe_apply(block.moe, h, qcfg,
                                 num_experts=cfg.num_experts,
                                 top_k=cfg.top_k, noise=noise)
    return block.mlp(h, qcfg, noise), None


def block_apply(block: Block, x: torch.Tensor, positions: torch.Tensor, cfg,
                qcfg: QuantConfig, noise=None, *, rope=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence pre-norm residual block (training forward). Returns
    (x, the MoE load-balancing loss or None)."""
    h = block.ln_attn(x, cfg.norm_eps)
    x = x + attention.attn_apply(
        block.attn, h, positions, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd, qcfg=qcfg,
        noise=noise, rope_theta=cfg.rope_theta, window=cfg.window,
        q_block=cfg.q_block, rope=rope)
    h = block.ln_ffn(x, cfg.norm_eps)
    y, aux = _ffn(block, h, cfg, qcfg, noise)
    return x + y, aux


def block_decode(block: Block, x: torch.Tensor, cache: Dict,
                 pos: torch.Tensor, cfg, qcfg: QuantConfig, *, rope,
                 write) -> torch.Tensor:
    """Pre-norm residual block over an S-token chunk; updates the layer's
    KV cache in place."""
    h = block.ln_attn(x, cfg.norm_eps)
    x = x + attention.attn_decode(
        block.attn, h, cache["kv"], pos, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd, qcfg=qcfg,
        rope=rope, write=write, window=cfg.window)
    h = block.ln_ffn(x, cfg.norm_eps)
    return x + _ffn(block, h, cfg, qcfg)[0]
