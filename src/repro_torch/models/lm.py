"""Top-level language model: init, the full-sequence forward and the
training loss, the decode cache, decode, chunked-prefill and speculative
verify steps, and the serving capabilities of a family. Counterpart of
``repro.models.lm``.

The model state is an :class:`LM` module; its ``tree()`` is the nested
dict of tensors the transforms and the weight bridge speak (per-layer
``blocks`` list, where the JAX package stacks layers ``[L, ...]``). Steps
update the KV cache (fp or 4-bit, ring or page pool) in place and
return it with the logits. The training forward recomputes each block in
its backward (``torch.utils.checkpoint``) unless ``cfg.remat == "none"``,
as the reference remats every layer; the Phase-I draws are keyed by the
linear's path, so the recomputation sees the same noise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import smol
from repro_torch.core.numerics import row_block_matmul
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve import kv_quant
from . import attention, blocks
from .common import (Embed, RMSNorm, embed_logits, embed_lookup,
                     rms_norm_init, rope_tables)

LOSS_CHUNK = 1024
Z_LOSS = 1e-4
MOE_AUX = 0.01           # weight of the MoE load-balancing loss


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
        for name, lin in smol.smol_linears(self):
            lin.path = name

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
    """Random model in the phase ``cfg.quant.mode`` selects (NOISE to
    start training, QAT for serving: the engine packs it), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default: the
    card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qcfg = cfg.quant
    dt = getattr(torch, cfg.param_dtype)
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=dev) * 0.02
    tree: Dict = {"embed": {"table": table.to(dt)},
                  "final_norm": rms_norm_init(cfg.d_model, device=dev)}
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
    per layer (``serve/kv_pool.py``; kernel B5 at 4 bits, the fp ring's
    plain attention over the gathered pages at fp): ``num_pages`` pages of
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
    """h [..., D] -> fp32 logits [..., V]. Serving takes the product in
    fixed row blocks (``core.numerics.row_block_matmul``), so a row's
    logits do not depend on how many rows the step reads out."""
    if cfg.tie_embeddings:
        if cfg.quant.mode == "serve":
            return row_block_matmul(h, model.embed.table.float().t())
        return embed_logits(model.embed.table, h)
    return smol.linear_apply(model.lm_head.leaf(), h.float(), cfg.quant)


# ------------------------------------------------------------- training ----
def _recompute(cfg) -> bool:
    return cfg.remat != "none" and torch.is_grad_enabled()


def forward(model: LM, cfg, tokens, *, positions=None,
            noise: Optional[smol.NoiseSource] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence forward: tokens [B, S] -> (the hidden state after the
    final norm [B, S, D], the MoE load-balancing loss summed over the
    blocks, None for a model without MoE blocks). The loss applies the
    readout in chunks. ``noise`` supplies the Phase-I draws
    (``cfg.quant.mode == "noise"``)."""
    dev = model.device
    tok = torch.as_tensor(tokens, device=dev).long()
    b, s = tok.shape
    x = embed_lookup(model.embed.table, tok, getattr(torch, cfg.dtype))
    if positions is None:
        positions = torch.arange(s, device=dev)[None].expand(b, s)
    positions = torch.as_tensor(positions, device=dev).long()
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    aux = None
    for block in model.blocks:
        if _recompute(cfg):
            x, a = checkpoint(blocks.block_apply, block, x, positions, cfg,
                              cfg.quant, noise, rope=rope,
                              use_reentrant=False)
        else:
            x, a = blocks.block_apply(block, x, positions, cfg, cfg.quant,
                                      noise, rope=rope)
        if a is not None:
            aux = a if aux is None else aux + a
    return model.final_norm(x, cfg.norm_eps), aux


def _chunk_loss(model: LM, cfg, h: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    lg = _readout(model, cfg, h)                        # [B, c, V] fp32
    mask = (y >= 0).float()
    yc = torch.clamp(y, min=0)
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, yc[..., None])[..., 0]
    ce = torch.sum((logz - ll) * mask)
    zl = torch.sum(torch.square(logz) * mask)
    return ce + Z_LOSS * zl, torch.sum(mask)


def lm_loss(model: LM, cfg, hidden: torch.Tensor, labels,
            chunk: int = LOSS_CHUNK) -> torch.Tensor:
    """Softmax cross-entropy plus the z-loss over the vocabulary, in
    sequence chunks (each recomputed in the backward, so the [B, S, V]
    logits are never all resident). Labels < 0 are masked out."""
    y = torch.as_tensor(labels, device=hidden.device).long()
    s = hidden.shape[1]
    c = chunk if s % chunk == 0 else math.gcd(s, chunk)
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for i in range(s // c):
        h, yi = hidden[:, i * c:(i + 1) * c], y[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            part, n = checkpoint(_chunk_loss, model, cfg, h, yi,
                                 use_reentrant=False)
        else:
            part, n = _chunk_loss(model, cfg, h, yi)
        tot = tot + part
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(model: LM, batch: Dict, cfg,
            noise: Optional[smol.NoiseSource] = None):
    """Scalar training loss: CE + z-loss + ``MOE_AUX`` * the MoE
    load-balancing loss + (Phase I) the SONIQ bit regularizer lambda *
    ||log2(1 + e^-s)||_1. Returns (loss, metrics); ``moe_aux`` is 0 for a
    model without MoE blocks."""
    hidden, aux = forward(model, cfg, batch["tokens"],
                          positions=batch.get("positions"), noise=noise)
    loss = lm_loss(model, cfg, hidden, batch["labels"])
    if aux is not None:
        loss = loss + MOE_AUX * aux
    else:
        aux = torch.zeros((), device=loss.device)
    if cfg.quant.mode == "noise":
        loss = loss + cfg.quant.lam * smol.bit_penalty_of_params(
            model).to(loss.device)
    return loss, {"ce": loss, "moe_aux": aux.detach()}


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


def verify_step(model: LM, cfg, cache: Dict, tokens, pos):
    """Speculative verify: the cache writes of :func:`prefill_step`
    (tokens [B, C], pos [B, C], -1 = padding lane), but fp32 logits of
    every lane, [B, C, V]: lane j scores the token after lane j's input.
    Prefill-phase slots riding the same call read their last real lane."""
    dev = model.device
    dt = getattr(torch, cfg.dtype)
    tok = torch.as_tensor(_host_array(tokens), dtype=torch.int64,
                          device=dev)
    x = embed_lookup(model.embed.table, tok, dt)
    x = _decode_core(model, cfg, cache, x, _host_array(pos))
    x = model.final_norm(x, cfg.norm_eps)
    return _readout(model, cfg, x), cache


@dataclasses.dataclass(frozen=True)
class ServeCaps:
    """Serving capabilities of a family (``DecodeEngine`` reads them).
    ``chunkable``: steps may feed C > 1 tokens a slot. ``spec_capable``:
    speculative rounds are supported. ``state``: "kv" (attention only),
    "ssm" or "hybrid"; recurrent state needs the snapshot/recommit
    flavour of speculation, which arrives with the SSM port. ``note``: why
    a capability is off, for the engine's error."""
    family: str
    chunkable: bool = True
    spec_capable: bool = True
    state: str = "kv"
    note: str = ""


def serve_capabilities(cfg) -> ServeCaps:
    """The capability descriptor of an arch config, as the reference
    derives it from the layer plan."""
    kinds = [kind for kind, _ in cfg.layer_plan()]
    has_ssm = any("mamba" in k or k.startswith("hybrid") for k in kinds)
    has_attn = bool(cfg.encoder_layers) or any(
        "attn" in k or k in ("dec", "enc") or k.startswith("hybrid")
        for k in kinds)
    state = "kv" if not has_ssm else ("hybrid" if has_attn else "ssm")
    if state == "kv":
        return ServeCaps(family=cfg.family)
    return ServeCaps(family=cfg.family, spec_capable=False, state=state,
                     note="speculative decoding of recurrent state "
                          "(snapshot/recommit) is not ported yet")


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
