"""Decoder block assembly (the dense ``attn_mlp`` kind). Counterpart of
``repro.models.blocks``; the other kinds arrive with their families."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.core.qtypes import QuantConfig
from repro_torch.serve import kv_pool, kv_quant
from . import attention
from . import mlp as mlp_lib
from .common import RMSNorm

KINDS = ("attn_mlp",)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} belongs to a later port slice (the port "
            f"serves {KINDS} so far)")


def block_init(kind: str, cfg, qcfg: QuantConfig, *, generator,
               device) -> Dict:
    _check_kind(kind)
    dt = getattr(torch, cfg.param_dtype)
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=device)
    return {
        "ln_attn": {"g": ones.clone()},
        "attn": attention.attn_init(
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, qcfg,
            generator=generator, device=device, use_bias=cfg.attn_bias,
            dtype=dt),
        "ln_ffn": {"g": ones.clone()},
        "mlp": mlp_lib.mlp_init(
            cfg.d_model, cfg.d_ff, qcfg, generator=generator, device=device,
            act=cfg.mlp_act, use_bias=cfg.attn_bias, dtype=dt),
    }


def block_cache_init(kind: str, cfg, batch: int, cache_len: int,
                     dtype=torch.bfloat16, *, device,
                     kv_bits: Optional[int] = None, kv_layout: str = "ring",
                     page_size: int = 16, num_pages: Optional[int] = None,
                     page_table: Optional[torch.Tensor] = None) -> Dict:
    """KV cache of one layer. The ring length is ``cache_len`` clipped to
    the window. ``kv_bits=None`` keeps the fp ring in ``dtype``; 4 the
    packed 4-bit ring (``serve/kv_quant.py``). ``kv_layout="paged"`` (4-bit
    only) draws ``page_size``-token pages from a pool of ``num_pages``
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
        if kv_bits is None:
            raise NotImplementedError(
                "the paged layout with an fp KV cache (kv_bits=None) is a "
                "later port slice; use kv_bits=4")
        if clen % page_size:
            raise ValueError(
                f"page_size {page_size} must divide the effective ring "
                f"length {clen} (cache_len clipped to the window) so "
                f"paged rollover wraps where the ring does")
        pps = clen // page_size
        npages = num_pages if num_pages is not None else batch * pps + 1
        return {"kv": kv_pool.init_paged_cache(
            npages, page_size, pps, batch, cfg.num_kv_heads, cfg.hd,
            device=device, table=page_table)}
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
        self.mlp = mlp_lib.MLP(tree["mlp"], act=act)

    def tree(self) -> Dict:
        return {"ln_attn": self.ln_attn.tree(), "attn": self.attn.tree(),
                "ln_ffn": self.ln_ffn.tree(), "mlp": self.mlp.tree()}


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
    return x + block.mlp(h, qcfg)
