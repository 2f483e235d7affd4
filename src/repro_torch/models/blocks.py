"""Decoder block assembly (the dense ``attn_mlp`` kind). Counterpart of
``repro.models.blocks``; the other kinds arrive with their families."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.core.qtypes import QuantConfig
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
                     dtype=torch.bfloat16, *, device) -> Dict:
    """fp ring KV cache of one layer (ring length clipped to the
    window)."""
    _check_kind(kind)
    clen = min(cache_len, cfg.window) if cfg.window else cache_len
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
    ring cache in place."""
    h = block.ln_attn(x, cfg.norm_eps)
    x = x + attention.attn_decode(
        block.attn, h, cache["kv"], pos, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd, qcfg=qcfg,
        rope=rope, write=write, window=cfg.window)
    h = block.ln_ffn(x, cfg.norm_eps)
    return x + block.mlp(h, qcfg)
