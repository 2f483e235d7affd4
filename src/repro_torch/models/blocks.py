"""Block assembly: the dense ``attn_mlp`` kind, the MoE ``attn_moe``
kind, the SSM ``mamba`` kind (an RMS-normed Mamba2 mixer, no FFN), the
hybrid's ``mamba_mlp`` and ``mamba_moe`` kinds (a Mamba2 mixer, then the
MLP or the MoE; a hybrid unit's attention sublayer is an ``attn_mlp`` or
``attn_moe``), and the encoder-decoder's ``enc`` (bidirectional
self-attention and the MLP) and ``dec`` (causal self-attention, cross
attention over the encoder's output, the MLP). A kind is a mixer
(:func:`mixer_of`) and an FFN (:func:`ffn_of`). Counterpart of
``repro.models.blocks``: the full-sequence forward (``block_apply``) and
the decode step over the layer's cache (KV for attention, the recurrent
state for the mixer; a ``dec`` layer also reads its cross K/V). The
reference nests a hybrid unit's sublayers (``sub0`` .. ``sub7``); the
port's model lists them flat (``models/lm.py``). Norms are RMSNorm or
LayerNorm as ``cfg.norm`` says; the encoder-decoder family has no rotary
encoding (sinusoids are added to its embeddings). As in the reference,
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
from . import ssm as ssm_lib
from .common import norm_init, norm_module

KINDS = ("attn_mlp", "attn_moe", "mamba", "mamba_mlp", "mamba_moe", "enc",
         "dec")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} belongs to a later port slice (the port "
            f"serves {KINDS} so far)")


def mixer_of(kind: str) -> str:
    """The kind's sequence mixer: "mamba" or "attn"."""
    return "mamba" if kind.startswith("mamba") else "attn"


def ffn_of(kind: str) -> Optional[str]:
    """The kind's feed-forward: "moe", "mlp", or None (``mamba``)."""
    if kind.endswith("moe"):
        return "moe"
    return None if kind == "mamba" else "mlp"


def uses_rope(cfg) -> bool:
    """Whether attention takes rotary encodings (the reference's
    ``use_rope``: not the audio family, which adds sinusoids)."""
    return cfg.family != "audio"


def block_init(kind: str, cfg, qcfg: QuantConfig, *, generator,
               device) -> Dict:
    _check_kind(kind)
    dt = getattr(torch, cfg.param_dtype)

    def attn():
        return attention.attn_init(
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, qcfg,
            generator=generator, device=device, use_bias=cfg.attn_bias,
            dtype=dt)

    p: Dict = {}
    if mixer_of(kind) == "attn":
        p["ln_attn"] = norm_init(cfg, device=device)
        p["attn"] = attn()
    if kind == "dec":
        p["ln_cross"] = norm_init(cfg, device=device)
        p["cross"] = attn()
    if mixer_of(kind) == "mamba":
        p["ln_mixer"] = norm_init(cfg, device=device)
        p["mamba"] = ssm_lib.mamba2_init(
            cfg.d_model, cfg.ssm_state, qcfg, generator=generator,
            device=device, expand=cfg.ssm_expand, dtype=dt)
    ffn = ffn_of(kind)
    if ffn is not None:
        p["ln_ffn"] = norm_init(cfg, device=device)
    if ffn == "moe":
        p["moe"] = moe_lib.moe_init(
            cfg.d_model, cfg.d_ff, cfg.num_experts, qcfg,
            generator=generator, device=device,
            num_shared=cfg.num_shared_experts, act=cfg.mlp_act, dtype=dt)
    elif ffn == "mlp":
        p["mlp"] = mlp_lib.mlp_init(
            cfg.d_model, cfg.d_ff, qcfg, generator=generator, device=device,
            act=cfg.mlp_act, use_bias=cfg.attn_bias, dtype=dt)
    return p


def block_cache_init(kind: str, cfg, batch: int, cache_len: int,
                     dtype=torch.bfloat16, *, device,
                     kv_bits: Optional[int] = None, kv_layout: str = "ring",
                     page_size: int = 16, num_pages: Optional[int] = None,
                     page_table: Optional[torch.Tensor] = None) -> Dict:
    """Cache of one layer: the recurrent state of a Mamba2 mixer
    (``{"ssm": {"h", "conv"}}``: h fp32, the conv window in ``dtype``; the
    KV options do not apply, the state stays fp as in the reference,
    DESIGN.md §5), else the KV cache. The ring length is ``cache_len``
    clipped to the window. ``kv_bits=None`` keeps the fp ring in
    ``dtype``; 4 the packed 4-bit ring (``serve/kv_quant.py``).
    ``kv_layout="paged"`` (fp or 4-bit) draws ``page_size``-token pages
    from a pool of ``num_pages`` (null page 0 included; None: ``batch *
    pages_per_seq + 1``) through a page table whose length is the ring
    length in pages, so ``page_size`` must divide it; ``page_table``
    shares one table across layers."""
    _check_kind(kind)
    if kv_bits not in (None, 4):
        raise ValueError(f"kv_bits must be None or 4, got {kv_bits}")
    if kv_layout not in ("ring", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r} (expected "
                         f"'ring' or 'paged')")
    if mixer_of(kind) == "mamba":
        return {"ssm": ssm_lib.init_ssm_cache(
            batch, cfg.d_model, cfg.ssm_state, expand=cfg.ssm_expand,
            dtype=dtype, device=device)}
    if kind == "enc":
        raise ValueError("an encoder block keeps no decode cache")
    clen = min(cache_len, cfg.window) if cfg.window else cache_len
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
        self.mixer, self.ffn = mixer_of(kind), ffn_of(kind)
        if self.mixer == "attn":
            self.ln_attn = norm_module(tree["ln_attn"])
            self.attn = attention.Attention(tree["attn"])
        if kind == "dec":
            self.ln_cross = norm_module(tree["ln_cross"])
            self.cross = attention.Attention(tree["cross"])
        if self.mixer == "mamba":
            self.ln_mixer = norm_module(tree["ln_mixer"])
            self.mamba = ssm_lib.Mamba2(tree["mamba"])
        if self.ffn is not None:
            self.ln_ffn = norm_module(tree["ln_ffn"])
        if self.ffn == "moe":
            self.moe = moe_lib.MoE(tree["moe"], act=act)
        elif self.ffn == "mlp":
            self.mlp = mlp_lib.MLP(tree["mlp"], act=act)

    def tree(self) -> Dict:
        out = {}
        if self.mixer == "attn":
            out["ln_attn"] = self.ln_attn.tree()
            out["attn"] = self.attn.tree()
        if self.kind == "dec":
            out["ln_cross"] = self.ln_cross.tree()
            out["cross"] = self.cross.tree()
        if self.mixer == "mamba":
            out["ln_mixer"] = self.ln_mixer.tree()
            out["mamba"] = self.mamba.tree()
        if self.ffn is not None:
            out["ln_ffn"] = self.ln_ffn.tree()
            out[self.ffn] = getattr(self, self.ffn).tree()
        return out


def _ffn(block: Block, h: torch.Tensor, cfg, qcfg: QuantConfig,
         noise=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's feed-forward and its MoE load-balancing loss (None for
    a dense block and in serving)."""
    if block.ffn == "moe":
        return moe_lib.moe_apply(block.moe, h, qcfg,
                                 num_experts=cfg.num_experts,
                                 top_k=cfg.top_k, noise=noise)
    return block.mlp(h, qcfg, noise), None


def _ffn_residual(block: Block, x: torch.Tensor, cfg, qcfg: QuantConfig,
                  noise=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x plus the block's pre-normed FFN (x itself for a ``mamba``
    block), and the MoE loss or None."""
    if block.ffn is None:
        return x, None
    y, aux = _ffn(block, block.ln_ffn(x, cfg.norm_eps), cfg, qcfg, noise)
    return x + y, aux


def _attn_kwargs(cfg, qcfg: QuantConfig) -> Dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.hd, qcfg=qcfg)


def block_apply(block: Block, x: torch.Tensor, positions: torch.Tensor, cfg,
                qcfg: QuantConfig, noise=None, *, rope=None, cross_x=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence pre-norm residual block (training forward; the
    encoder's blocks; a ``dec`` block attends ``cross_x``, the encoder's
    output). ``positions`` [B, S], or the VLM's [3, B, S] streams. Returns
    (x, the MoE load-balancing loss or None)."""
    if block.mixer == "mamba":
        h = block.ln_mixer(x, cfg.norm_eps)
        x = x + ssm_lib.mamba2_apply(
            block.mamba, h, qcfg, noise, d_state=cfg.ssm_state,
            expand=cfg.ssm_expand, chunk=cfg.ssm_chunk)
        return _ffn_residual(block, x, cfg, qcfg, noise)
    kw = dict(_attn_kwargs(cfg, qcfg), noise=noise,
              rope_theta=cfg.rope_theta,
              mrope_sections=cfg.mrope_sections, window=cfg.window,
              q_block=cfg.q_block, use_rope=uses_rope(cfg))
    h = block.ln_attn(x, cfg.norm_eps)
    x = x + attention.attn_apply(block.attn, h, positions, rope=rope,
                                 causal=block.kind != "enc", **kw)
    if block.kind == "dec":
        h = block.ln_cross(x, cfg.norm_eps)
        x = x + attention.attn_apply(block.cross, h, positions,
                                     cross_x=cross_x, **kw)
    return _ffn_residual(block, x, cfg, qcfg, noise)


def block_decode(block: Block, x: torch.Tensor, cache: Dict,
                 pos: torch.Tensor, cfg, qcfg: QuantConfig, *, rope,
                 write, cross_kv: Optional[Dict] = None) -> torch.Tensor:
    """Pre-norm residual block over an S-token chunk at positions ``pos``
    [B, S] (< 0: a masked lane); updates the layer's cache in place. A
    Mamba2 mixer dispatches as the reference does: S > 1 through the
    chunked prefill (its padding lanes state-neutral), S = 1 through the
    O(1) decode, which advances every row; ``rope`` and ``write`` are the
    attention's and unused there. A ``dec`` layer attends its cross K/V
    ``cross_kv`` (one layer's slice of the cache's ``cross`` subtree)
    after its self-attention."""
    if block.mixer == "mamba":
        h = block.ln_mixer(x, cfg.norm_eps)
        kw = dict(d_state=cfg.ssm_state, expand=cfg.ssm_expand)
        if x.shape[1] > 1:
            y = ssm_lib.mamba2_prefill(block.mamba, h, cache["ssm"], pos,
                                       qcfg, chunk=cfg.ssm_chunk, **kw)
        else:
            y = ssm_lib.mamba2_decode(block.mamba, h, cache["ssm"], qcfg,
                                      **kw)
        return _ffn_residual(block, x + y, cfg, qcfg)[0]
    h = block.ln_attn(x, cfg.norm_eps)
    x = x + attention.attn_decode(
        block.attn, h, cache["kv"], pos, rope=rope, write=write,
        window=cfg.window, **_attn_kwargs(cfg, qcfg))
    if block.kind == "dec" and cross_kv is not None:
        h = block.ln_cross(x, cfg.norm_eps)
        x = x + attention.cross_attn_decode(block.cross, h, cross_kv,
                                            **_attn_kwargs(cfg, qcfg))
    return _ffn_residual(block, x, cfg, qcfg)[0]
