"""Top-level language model for serving: init, decode cache, decode and
chunked-prefill steps. Counterpart of ``repro.models.lm``.

The model state is an :class:`LM` module; its ``tree()`` is the nested
dict of tensors the transforms and the weight bridge speak (per-layer
``blocks`` list, where the JAX package stacks layers ``[L, ...]``). Steps
update the KV cache (fp ring, 4-bit ring or 4-bit page pool) in place and
return it with the logits.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core import smol
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve import kv_quant
from . import attention, blocks
from .common import Embed, RMSNorm, embed_logits, embed_lookup, rope_tables


class LM(nn.Module):
    """Decoder-only LM: embed, blocks, final norm, readout."""

    def __init__(self, cfg, tree: Dict):
        super().__init__()
        if cfg.norm != "rms":
            raise NotImplementedError("only RMSNorm archs are ported")
        self.cfg = cfg
        self.embed = Embed(tree["embed"])
        self.final_norm = RMSNorm(tree["final_norm"])
        self.lm_head = None if cfg.tie_embeddings else \
            smol.SmolLinear(tree["lm_head"])
        kinds = [kind for kind, count in cfg.layer_plan()
                 for _ in range(count)]
        if len(kinds) != len(tree["blocks"]):
            raise ValueError(f"{len(tree['blocks'])} blocks for a plan of "
                             f"{len(kinds)} layers")
        self.blocks = nn.ModuleList(
            blocks.Block(kind, bt, act=cfg.mlp_act)
            for kind, bt in zip(kinds, tree["blocks"]))

    def tree(self) -> Dict:
        out = {"embed": self.embed.tree(),
               "final_norm": self.final_norm.tree(),
               "blocks": [b.tree() for b in self.blocks]}
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head.leaf()
        return out

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_params(cfg, *, seed: int = 0, device: DeviceLike = None) -> LM:
    """Random model in the phase ``cfg.quant.mode`` selects (QAT for
    serving: the engine packs it), drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qcfg = cfg.quant
    dt = getattr(torch, cfg.param_dtype)
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=dev) * 0.02
    tree: Dict = {"embed": {"table": table.to(dt)},
                  "final_norm": {"g": torch.ones((cfg.d_model,),
                                                 device=dev)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = smol.linear_init(
            cfg.d_model, cfg.vocab_size, qcfg, generator=gen, device=dev,
            quantized=False, dtype=dt)
    tree["blocks"] = [blocks.block_init(kind, cfg, qcfg, generator=gen,
                                        device=dev)
                      for kind, count in cfg.layer_plan()
                      for _ in range(count)]
    return LM(cfg, tree)


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16, *,
               device: DeviceLike = None, kv_bits: Optional[int] = None,
               kv_layout: str = "ring", page_size: int = 16,
               num_pages: Optional[int] = None) -> Dict:
    """Decode cache, ``{"layers": [{"kv": {...}}]}`` with one dict per
    layer. ``kv_bits=None`` keeps fp rings in ``dtype``; 4 selects the
    packed 4-bit family (``serve/kv_quant.py``, attention through kernel
    B4). ``kv_layout="paged"`` swaps the per-slot rings for a page pool
    per layer (``serve/kv_pool.py``, kernel B5): ``num_pages`` pages of
    ``page_size`` tokens shared by the slots through one page table that
    every layer reads. The paged layout needs the engine's ``PagePool``
    to drive allocation."""
    dev = resolve_device(device)
    layers = []
    table = None
    for kind, count in cfg.layer_plan():
        for _ in range(count):
            layers.append(blocks.block_cache_init(
                kind, cfg, batch, cache_len, dtype, device=dev,
                kv_bits=kv_bits, kv_layout=kv_layout, page_size=page_size,
                num_pages=num_pages, page_table=table))
            table = layers[-1]["kv"].get("page_table")
    return {"layers": layers}


def _readout(model: LM, cfg, h: torch.Tensor) -> torch.Tensor:
    """h [..., D] -> fp32 logits [..., V]."""
    if cfg.tie_embeddings:
        return embed_logits(model.embed.table, h)
    return smol.linear_apply(model.lm_head.leaf(), h.float(), cfg.quant)


def _decode_core(model: LM, cfg, cache: Dict, x: torch.Tensor,
                 pos) -> torch.Tensor:
    """Run x [B, S, D] at host positions ``pos`` [B, S] (< 0 = masked lane,
    its cache writes dropped) through every block, updating the cache in
    place. Returns the hidden state before the final norm."""
    pos_host = np.asarray(pos, np.int64)
    posb = torch.as_tensor(pos_host, device=x.device)
    rope = rope_tables(posb, cfg.hd, cfg.rope_theta)
    write = attention.cache_write_index(cache["layers"][0]["kv"], pos_host,
                                        x.device)
    for block, layer_cache in zip(model.blocks, cache["layers"]):
        x = blocks.block_decode(block, x, layer_cache, posb, cfg, cfg.quant,
                                rope=rope, write=write)
    return x


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def decode_step(model: LM, cfg, cache: Dict, tokens, pos, *, active=None):
    """One decode step. tokens [B], pos [B] (host arrays or tensors);
    ``active`` [B] bool marks live slots (others get position -1: no
    cache write, logits ignored). Returns (fp32 logits [B, V], cache)."""
    pos = _host_array(pos).astype(np.int64)
    if active is not None:
        pos = np.where(_host_array(active), pos, -1)
    dev = model.device
    dt = getattr(torch, cfg.dtype)
    tok = torch.as_tensor(_host_array(tokens), dtype=torch.int64,
                          device=dev)
    x = embed_lookup(model.embed.table, tok[:, None], dt)
    x = _decode_core(model, cfg, cache, x, pos[:, None])
    x = model.final_norm(x[:, 0], cfg.norm_eps)
    return _readout(model, cfg, x), cache


def prefill_step(model: LM, cfg, cache: Dict, tokens, pos, last_idx):
    """Chunked prefill: tokens [B, C], pos [B, C] (-1 = padding lane),
    last_idx [B] the lane of each slot's last real token. Returns (fp32
    logits [B, V] of each slot's last token, cache)."""
    dev = model.device
    dt = getattr(torch, cfg.dtype)
    tok = torch.as_tensor(_host_array(tokens), dtype=torch.int64,
                          device=dev)
    x = embed_lookup(model.embed.table, tok, dt)
    x = _decode_core(model, cfg, cache, x, _host_array(pos))
    last = torch.as_tensor(_host_array(last_idx), dtype=torch.int64,
                           device=dev)
    h = x[torch.arange(x.shape[0], device=dev), last]
    h = model.final_norm(h, cfg.norm_eps)
    return _readout(model, cfg, h), cache


def reset_cache_slots(cache: Dict, slots) -> Dict:
    """Wipe the cache rows of the given batch slots in place: fp K/V and
    4-bit codes/scales to 0, ``pos`` to -1 (entries read as empty). A
    paged layer's pool is shared state owned by the host allocator: only
    the slots' page-table rows become -1 (every logical page unmapped);
    ``PagePool.release`` and ``kv_pool.apply_step_ops`` recycle pages."""
    for layer in cache["layers"]:
        kv = layer["kv"]
        if "page_table" in kv:
            idx = torch.as_tensor(np.asarray(slots, np.int64),
                                  device=kv["pos"].device)
            kv["page_table"][idx] = -1
        else:
            kv_quant.reset_slots(kv, slots)
    return cache
